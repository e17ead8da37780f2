"""The port's ``Synthesizer`` against the JAX ``Synthesizer`` on the same
tiny native checkpoints, on the CPU.

Both sides run with prenet dropout off and the float32 vocoder.  The JAX
side takes its plain routes (``fused_decode=False``,
``fused_inference=False``), which its own tests hold equal to its Pallas
kernels, and ``single_dispatch_max_tokens = 0``: otherwise its CPU
``synthesize`` takes the single-dispatch program, whose static frame
budget pads the vocoder input differently and so changes the tail.

Tolerances: durations 1e-5 and mel 1e-4 (float32 recurrences with
differently ordered sums); waveform 1e-3, the parity bar of BASELINE.md.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viettts_tpu.config import (
    AcousticModelConfig,
    Config,
    DataConfig,
    DurationModelConfig,
    HifiGanConfig,
    apply_overrides,
)
from viettts_tpu.infer.pipeline import Synthesizer as JaxSynthesizer
from viettts_tpu.models import AcousticModel, DurationModel, Generator
from viettts_tpu.train.checkpoint import NATIVE_FORMAT, save_checkpoint
from viettts_tpu.types import AcousticBatch, DurationBatch
from viettts_tpu_torch.infer import pipeline as torch_pipeline

TEXTS = ["một hai ba", "bốn năm sáu bảy tám chín mười"]
LONG_TEXT = "xin chào các bạn. hôm nay trời đẹp, chúng ta đi chơi nhé"


def _cfg(ckpt_dir=None):
    cfg = Config(
        duration=DurationModelConfig(lstm_dim=16),
        acoustic=AcousticModelConfig(
            encoder_dim=16, decoder_dim=16, prenet_dim=8, postnet_dim=8,
            prenet_dropout_at_inference=False, fused_decode=False,
        ),
        hifigan=HifiGanConfig(
            upsample_rates=(8, 8, 2, 2),
            upsample_kernel_sizes=(16, 16, 4, 4),
            upsample_initial_channel=16,
            resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3, 5),),
            fused_inference=False,
            inference_dtype="float32",
        ),
    )
    return cfg if ckpt_dir is None else cfg.replace(ckpt_dir=ckpt_dir)


def _seeded(tree, rng, gain=1.0):
    """Seeded numpy values in place of every leaf of a shape tree: weights
    at gain/sqrt(fan_in), small biases and means, BatchNorm scales and
    variances near 1."""

    def leaf(path, a):
        name, shape = str(path[-1]), a.shape
        noise = rng.randn(*shape).astype(np.float32)
        if "var" in name or "scale" in name:
            return 1.0 + 0.1 * noise
        if len(shape) >= 2:
            return gain * noise / np.sqrt(np.prod(shape[:-1]))
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _write_checkpoints(cfg, d, seed=0):
    """Native checkpoints of seeded tiny models (shapes from the flax
    modules, values from numpy); the duration head's bias is set so tokens
    last about 80 ms, a speaking pace."""
    rng = np.random.RandomState(seed)
    toks = jnp.zeros((1, 8), jnp.int32)
    lengths = jnp.asarray([8], jnp.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "prenet", "zoneout"))}

    def shapes(model, *args, gain=1.0, **kwargs):
        return _seeded(dict(jax.eval_shape(lambda: model.init(*args, **kwargs))), rng, gain)

    dvars = shapes(DurationModel(cfg.duration), keys, DurationBatch(toks, lengths, None), train=False)
    dvars["params"]["proj_1"]["bias"] = np.full((1,), -2.5, np.float32)
    avars = shapes(
        AcousticModel(cfg.acoustic), keys,
        AcousticBatch(toks, lengths, jnp.ones((1, 8)), None, None, jnp.zeros((1, 16, 80))),
        train=True,
    )
    # gain 1.5: a waveform of order 0.5, so the 1e-3 bar is a real test
    gvars = shapes(Generator(cfg.hifigan), jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)), gain=1.5)
    for name, variables in (
        ("duration", dvars),
        ("acoustic", {"params": avars["params"], "batch_stats": avars["batch_stats"]}),
        ("hifigan", gvars),
    ):
        save_checkpoint(
            d / f"{name}_latest_ckpt.pickle",
            {"format": NATIVE_FORMAT, "step": 0, "variables": variables},
        )
    return d


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_port_ckpts"))


def _pair(cfg):
    jax_synth = JaxSynthesizer(cfg)
    jax_synth.single_dispatch_max_tokens = 0
    return jax_synth, torch_pipeline.Synthesizer(cfg, device="cpu")


@pytest.fixture(scope="module")
def synths(ckpt_dir):
    return _pair(_cfg(ckpt_dir))


def _assert_close(got, want):
    np.testing.assert_allclose(got.durations, want.durations, atol=1e-5)
    assert got.mel.shape == want.mel.shape
    np.testing.assert_allclose(got.mel, want.mel, atol=1e-4)
    assert got.wave.shape == want.wave.shape == (want.mel.shape[0] * 256,)
    np.testing.assert_allclose(got.wave, want.wave, atol=1e-3)


def test_synthesize_matches_jax(synths):
    jax_synth, port = synths
    _assert_close(port.synthesize(TEXTS[1]), jax_synth.synthesize(TEXTS[1]))


def test_synthesize_batch_matches_jax(synths):
    jax_synth, port = synths
    got, want = port.synthesize_batch(TEXTS), jax_synth.synthesize_batch(TEXTS)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_close(g, w)


def test_long_form_chunking_matches_jax(ckpt_dir):
    cfg = _cfg(ckpt_dir).replace(data=DataConfig(max_phoneme_seq_len=16))
    jax_synth, port = _pair(cfg)
    assert len(port.text_to_token_ids(LONG_TEXT)) > 16
    _assert_close(port.synthesize(LONG_TEXT), jax_synth.synthesize(LONG_TEXT))


def test_cli_writes_wav(ckpt_dir, tmp_path, monkeypatch):
    """The port's CLI end to end on the CPU: one text, then batch mode.
    ``Config()`` is swapped for the tiny config, which ``--set`` cannot
    spell (its dilations are a tuple of tuples)."""
    import viettts_tpu_torch.config as config_mod
    from viettts_tpu.data.audio import read_wav
    from viettts_tpu_torch import synthesizer as cli

    monkeypatch.setattr(config_mod, "Config", _cfg)
    out, lines = tmp_path / "clip.wav", tmp_path / "lines.txt"
    lines.write_text("một hai\nba bốn năm\n")
    common = ["--ckpt-dir", str(ckpt_dir), "--device", "cpu", "--quality"]
    assert cli.main(common + ["--text", "một hai ba", "--output", str(out)]) == 0
    assert cli.main(common + ["--text-file", str(lines), "--output-dir", str(tmp_path / "batch")]) == 0
    sr, pcm = read_wav(out)
    assert sr == 16000 and len(pcm) > 0 and len(pcm) % 256 == 0
    assert sorted(p.name for p in (tmp_path / "batch").iterdir()) == ["0000.wav", "0001.wav"]


def test_int8_route_is_refused(ckpt_dir):
    cfg = apply_overrides(_cfg(ckpt_dir), ["hifigan.inference_dtype=int8"])
    with pytest.raises(NotImplementedError, match="not ported"):
        torch_pipeline.Synthesizer(cfg, device="cpu")


def test_cuda_device_without_gpu_fails_loudly(ckpt_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU failure cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_pipeline.Synthesizer(_cfg(ckpt_dir), device="cuda")
