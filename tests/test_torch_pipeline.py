"""The port's ``Synthesizer`` against the JAX ``Synthesizer`` on the same
tiny native checkpoints, on the CPU.

Both sides run with prenet dropout off and the float32 vocoder.  The JAX
side takes its plain routes (``fused_decode=False``,
``fused_inference=False``), which its own tests hold equal to its Pallas
kernels.  ``_pair`` sets ``single_dispatch_max_tokens = 0`` on both sides,
so that these tests cover the bucketed path; the single-dispatch lead
program, which both take by default, is held to JAX's in
``tests/test_torch_lead.py``.

Tolerances: durations 1e-5 and mel 1e-4 (float32 recurrences with
differently ordered sums); waveform 1e-3, the parity bar of BASELINE.md.
"""

import dataclasses

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


def port_config(cfg):
    """The port's own config tree with the same fields as a JAX one."""
    from viettts_tpu_torch import config as port

    if dataclasses.is_dataclass(cfg):
        cls = getattr(port, type(cfg).__name__)
        return cls(**{f.name: port_config(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})
    return cfg


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


def _write_checkpoints(cfg, d, seed=0, vocoder_gain=1.5):
    """Native checkpoints of seeded tiny models (shapes from the flax
    modules, values from numpy); the duration head's bias is set so tokens
    last about 80 ms, a speaking pace.  ``vocoder_gain`` 1.5 gives a
    waveform of order 0.5, so the 1e-3 bar is a real test."""
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
    gvars = shapes(Generator(cfg.hifigan), jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)), gain=vocoder_gain)
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
    """JAX's and the port's Synthesizer on ``cfg``, both on the bucketed path."""
    jax_synth = JaxSynthesizer(cfg)
    port = torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    jax_synth.single_dispatch_max_tokens = port.single_dispatch_max_tokens = 0
    return jax_synth, port


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
    ``Config()`` is swapped for the tiny config (the port's own tree), which ``--set`` cannot
    spell (its dilations are a tuple of tuples)."""
    import viettts_tpu_torch.config as config_mod
    from viettts_tpu.data.audio import read_wav  # the JAX package reads what the port wrote
    from viettts_tpu_torch import synthesizer as cli

    tiny = port_config(_cfg())
    monkeypatch.setattr(config_mod, "Config", lambda: tiny)
    out, lines = tmp_path / "clip.wav", tmp_path / "lines.txt"
    lines.write_text("một hai\nba bốn năm\n")
    common = ["--ckpt-dir", str(ckpt_dir), "--device", "cpu", "--quality"]
    assert cli.main(common + ["--text", "một hai ba", "--output", str(out)]) == 0
    assert cli.main(common + ["--text-file", str(lines), "--output-dir", str(tmp_path / "batch")]) == 0
    sr, pcm = read_wav(out)
    assert sr == 16000 and len(pcm) > 0 and len(pcm) % 256 == 0
    assert sorted(p.name for p in (tmp_path / "batch").iterdir()) == ["0000.wav", "0001.wav"]


def _int8(cfg):
    """The int8 route; JAX has it only on its fused vocoder."""
    return apply_overrides(cfg, ["hifigan.inference_dtype=int8", "hifigan.fused_inference=true"])


def test_int8_route_runs_on_cpu(ckpt_dir):
    port = torch_pipeline.Synthesizer(port_config(_int8(_cfg(ckpt_dir))), device="cpu")
    assert port.vocoder_quant and port.vocoder_dtype == torch.bfloat16
    dynamic = port.synthesize(TEXTS[1])  # not calibrated yet: dynamic scales
    port.warmup(token_buckets=(32,))
    assert port._act_scales is not None and sorted(port._act_scales) == [0, 1, 2, 3]
    static = port.synthesize(TEXTS[1])
    for res in (dynamic, static):
        assert np.isfinite(res.wave).all() and np.abs(res.wave).max() <= 1.0
        assert res.wave.shape == (res.mel.shape[0] * 256,)
    stats = port.int8_clip_stats(mel=static.mel)
    assert port.last_clip_stats is stats and 0.0 <= stats["max_clip_fraction"] <= 1.0
    assert sorted(stats["per_stage"]) == [0, 1, 2, 3]


def test_calibrate_int8_runs_on_cpu(ckpt_dir):
    """calibrate_int8 calibrates on the CPU too (True), as the per-text max
    widened by the 1.25 margin; the float routes have nothing to calibrate."""
    from viettts_tpu_torch.models.hifigan import generator_calibrate_int8

    port = torch_pipeline.Synthesizer(port_config(_int8(_cfg(ckpt_dir))), device="cpu")
    assert port.calibrate_int8(texts=TEXTS) is True
    per_text = [generator_calibrate_int8(port.generator, port._calibration_mel(t)) for t in TEXTS]
    for i, scales in port._act_scales.items():
        want = 1.25 * torch.maximum(per_text[0][i], per_text[1][i])
        torch.testing.assert_close(scales, want, rtol=1e-6, atol=0)
    assert port.calibrate_int8() is True  # the built-in calibration texts
    f32 = torch_pipeline.Synthesizer(port_config(_cfg(ckpt_dir)), device="cpu")
    assert f32.calibrate_int8() is False and f32._act_scales is None
    with pytest.raises(RuntimeError, match="requires static-int8 calibration"):
        f32.int8_clip_stats(text=TEXTS[0])


@pytest.fixture(scope="module")
def int8_ckpt_dir(tmp_path_factory):
    """Checkpoints with a vocoder gain of 0.5.  The int8 route amplifies a
    one-ulp bf16 difference of the mel by the generator's gain: at 1.5 the
    ~6e-7 mel difference between the packages moves even the JAX route
    by ~4% rel-RMS (three flipped mel values move it 1-8e-2 at 1.5 and
    1-8e-4 at 0.5), which would swamp any fault of the port."""
    return _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_port_int8_ckpts"), vocoder_gain=0.5)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_synthesize_matches_jax(int8_ckpt_dir, scales):
    """The int8 route against the JAX int8 route (fused vocoder, Pallas in
    interpret mode), with static scales installed by hand on both sides as
    tests/test_pipeline.py does, or dynamic.  Bars: rel-RMS 5e-3 and max
    abs 0.02 of max(|ref|, 1); durations and mel as the float route."""
    from viettts_tpu.models.hifigan import generator_calibrate_int8

    jax_synth, port = _pair(_int8(_cfg(int8_ckpt_dir)))
    if scales == "static":
        mel = jnp.asarray(port._calibration_mel(TEXTS[0]).numpy())
        jax_scales = generator_calibrate_int8(jax_synth.cfg.hifigan, jax_synth._hifigan_vars["params"], mel)
        jax_synth._act_scales = jax_scales
        jax_synth._build_vocode()
        port._act_scales = {i: torch.tensor(np.asarray(v)) for i, v in jax_scales.items()}
    got, want = port.synthesize(TEXTS[1]), jax_synth.synthesize(TEXTS[1])
    np.testing.assert_allclose(got.durations, want.durations, atol=1e-5)
    np.testing.assert_allclose(got.mel, want.mel, atol=1e-4)
    assert got.wave.shape == want.wave.shape
    rel_rms = np.sqrt(np.mean((got.wave - want.wave) ** 2)) / np.sqrt(np.mean(want.wave ** 2))
    assert rel_rms <= 5e-3
    assert np.abs(got.wave - want.wave).max() <= 0.02 * max(float(np.abs(want.wave).max()), 1.0)


STREAM_TEXT = "một hai ba bốn năm sáu bảy tám chín mười"


def test_stream_matches_synthesize_and_jax(ckpt_dir):
    """stream() with a 16-token chunk cap: the chunks concatenate to
    ``synthesize`` (1e-5) and match the JAX ``stream`` chunk by chunk (the
    parity bars above).  JAX streams with ``lead_tokens=0``: its lead chunk
    otherwise takes the single-dispatch program, whose frame budget pads
    the vocoder differently; at this chunk cap the chunks are the same."""
    cfg = _cfg(ckpt_dir).replace(data=DataConfig(max_phoneme_seq_len=16))
    jax_synth, port = _pair(cfg)
    chunks = list(port.stream(STREAM_TEXT))
    assert len(chunks) >= 2
    whole = port.synthesize(STREAM_TEXT)
    got = np.concatenate([c.wave for c in chunks])
    assert got.shape == whole.wave.shape
    np.testing.assert_allclose(got, whole.wave, atol=1e-5)
    want = list(jax_synth.stream(STREAM_TEXT, lead_tokens=0))
    assert len(want) == len(chunks)
    for g, w in zip(chunks, want):
        _assert_close(g, w)


def test_stream_leads_with_a_short_chunk(ckpt_dir):
    """A short chunk 0 on the bucketed path (the lead program is off: its
    frame budget pads the vocoder otherwise than a row alone does)."""
    port = torch_pipeline.Synthesizer(port_config(_cfg(ckpt_dir)), device="cpu")
    port.single_dispatch_max_tokens = 0
    tokens = port.text_to_token_ids(LONG_TEXT)
    rows = torch_pipeline._chunk_token_rows(tokens, 256, first_chunk_tokens=12)
    assert len(rows) >= 2 and len(rows[0]) <= 12
    chunks = list(port.stream(LONG_TEXT, lead_tokens=12))
    assert [len(c.durations) for c in chunks] == [len(r) for r in rows]
    # durations come from one batch padded to the longest chunk, each decode
    # from its own token bucket: a row alone gives the same audio
    for chunk, row in zip(chunks, rows):
        alone = port._synthesize_rows([row])[0]
        np.testing.assert_allclose(chunk.durations, alone.durations, atol=1e-6)
        assert chunk.wave.shape == alone.wave.shape
        np.testing.assert_allclose(chunk.wave, alone.wave, atol=1e-5)


def test_cli_stream_matches_one_shot(ckpt_dir, tmp_path, monkeypatch):
    """--stream writes the wav chunk by chunk; it matches the one-shot wav
    to one int16 step, both on the bucketed path (the one-shot text is
    chunked; a lead chunk 0 would decode a different frame budget)."""
    import wave

    import viettts_tpu_torch.config as config_mod
    from viettts_tpu_torch import synthesizer as cli

    tiny = port_config(_cfg())
    monkeypatch.setattr(config_mod, "Config", lambda: tiny)
    monkeypatch.setattr(torch_pipeline.Synthesizer, "single_dispatch_max_tokens", 0)
    common = ["--text", STREAM_TEXT, "--ckpt-dir", str(ckpt_dir), "--device", "cpu",
              "--set", "data.max_phoneme_seq_len=16"]  # at least two chunks
    one, streamed = tmp_path / "one.wav", tmp_path / "streamed.wav"
    assert cli.main(common + ["--output", str(one)]) == 0
    assert cli.main(common + ["--output", str(streamed), "--stream", "--save-mel", str(tmp_path / "mel")]) == 0
    with wave.open(str(one)) as w1, wave.open(str(streamed)) as w2:
        assert w1.getnframes() == w2.getnframes() > 0
        a = np.frombuffer(w1.readframes(w1.getnframes()), "<i2").astype(np.int32)
        b = np.frombuffer(w2.readframes(w2.getnframes()), "<i2").astype(np.int32)
    assert np.abs(a - b).max() <= 1
    assert np.load(tmp_path / "mel.npy").shape == (len(a) // 256, 80)


def test_cuda_device_without_gpu_fails_loudly(ckpt_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU failure cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_pipeline.Synthesizer(port_config(_cfg(ckpt_dir)), device="cuda")


def test_stream_yields_chunk_0_before_dispatching_chunk_1(ckpt_dir):
    """stream() fetches and yields chunk 0 as soon as it is dispatched;
    from chunk 1 on one chunk stays in flight (chunk i+1 is dispatched
    before chunk i is fetched)."""
    cfg = _cfg(ckpt_dir).replace(data=DataConfig(max_phoneme_seq_len=16))
    port = torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    port.single_dispatch_max_tokens = 0  # chunk 0 on the bucketed path too
    log = []

    def dispatch(token_rows, toks, lengths, dur_s):
        i = sum(1 for event in log if event[0] == "dispatch")
        log.append(("dispatch", i))
        return i

    def finalize(handle):
        log.append(("finalize", handle))
        return [handle]

    port._dispatch, port._finalize = dispatch, finalize
    for chunk in port.stream(LONG_TEXT, lead_tokens=12):
        log.append(("yield", chunk))
    n = sum(1 for event in log if event[0] == "yield")
    assert n >= 3
    want = [("dispatch", 0), ("finalize", 0), ("yield", 0), ("dispatch", 1)]
    for i in range(2, n):
        want += [("dispatch", i), ("finalize", i - 1), ("yield", i - 1)]
    want += [("finalize", n - 1), ("yield", n - 1)]
    assert log == want
