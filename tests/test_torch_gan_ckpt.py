"""The port's HiFi-GAN trainer beyond one float32 step, against the JAX
trainer on the CPU, at the tiny widths of ``test_torch_gan_models``
(segment 512, B=4):

* the bf16 mixed-precision step's losses within 2e-2 relative of JAX's;
* checkpoints both ways (JAX resumes, steps and serves a port-written
  one; the port resumes a JAX-written one and continues its step count);
* ``--disc-init`` and its loud rejection of a mismatched tree; the entry
  point with ``--device cpu``, and without a card and without it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viettts_tpu.config import Config, DataConfig, TrainConfig
from viettts_tpu.models import hifigan as jax_hifigan
from viettts_tpu.train import checkpoint as jax_ckpt
from viettts_tpu.train import hifigan as jax_train
from viettts_tpu_torch import checkpoint as ckpt
from viettts_tpu_torch.train import checkpoint as port_train_ckpt
from viettts_tpu_torch.train import hifigan as port_train

from test_torch_checkpoint import _flat
from test_torch_gan_models import HCFG, jax_gan_variables, port_models
from test_torch_gan_train import (
    B, FRAMES, LR, SEG, SR, _batch, _cfg, _jax_side, _jax_state, _port_side, f32_step, wavs,  # noqa: F401
)
from test_torch_pipeline import port_config


def test_mixed_precision_gan_step_matches_jax():
    """bf16 compute (the generator's convs, the discriminators with their
    parameters and ``u`` cast before the fold): every loss within 2e-2
    relative of JAX's bf16 step; masters and moments stay float32."""
    cfg = _cfg(mixed=True)
    gen_params, disc_params, spectral = jax_gan_variables(HCFG, seed=13, frames=FRAMES, length=SEG)
    jstep, tx = _jax_side(cfg)
    mel, audio = _batch(14, False)
    jstate, jm = jstep(_jax_state(tx, gen_params, disc_params, spectral), None, jnp.asarray(audio))
    pstep, pstate, _, _ = _port_side(cfg, gen_params, disc_params, spectral)
    pstate, pm = pstep(pstate, None, torch.from_numpy(audio))
    for k in port_train.METRICS:
        got, want = float(pm[k]), float(jm[k])
        assert np.isfinite(got) and abs(got - want) <= 2e-2 * abs(want), (k, got, want)
    tensors = [*pstate.gen_params.values(), *pstate.disc_params.values(), *pstate.spectral.values(),
               *pstate.gen_opt.mu.values(), *pstate.disc_opt.nu.values()]
    assert all(t.dtype == torch.float32 for t in tensors)


# ---------------------------------------------------------------------------
# Checkpoints and the trainer.
# ---------------------------------------------------------------------------

def _train_cfg(ckpt_dir, wav_dir, **train):
    return port_config(Config(
        hifigan=HCFG, data=DataConfig(max_phoneme_seq_len=16, max_wave_len=SR),
        train=TrainConfig(batch_size=B, num_training_steps=2, **train), ckpt_dir=ckpt_dir, data_dir=wav_dir,
    ))


def test_port_checkpoint_resumes_and_serves_in_jax(wavs, tmp_path, f32_step):
    """A port-written ``hifigan_latest_ckpt.pickle``: JAX's
    ``restore_vocoder_state`` takes it and JAX trains one more step from
    it; JAX's ``load_variables`` serves its folded params, which give the
    port's waveform."""
    cfg = _train_cfg(tmp_path, wavs, ckpt_interval=1)
    state = port_train.train(cfg, wav_dir=wavs, num_steps=1, log_every=1, device="cpu")
    path = tmp_path / "hifigan_latest_ckpt.pickle"
    jstep, tx = f32_step
    g, d, s = jax_gan_variables(HCFG, seed=0, frames=FRAMES, length=SEG)
    restored = jax_train.restore_vocoder_state(path, _jax_state(tx, g, d, s))
    assert int(restored.step) == 1
    for tree, named in ((restored.gen_params, state.gen_params), (restored.disc_params, state.disc_params),
                        (restored.spectral, state.spectral), (restored.gen_opt[0].mu, state.gen_opt.mu)):
        want = _flat(ckpt.gan_tree(named))
        got = _flat(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)

    variables = jax_ckpt.load_variables(path, "hifigan")
    mel = np.random.RandomState(17).randn(2, 6, 80).astype(np.float32)
    want = jax_hifigan.Generator(HCFG).apply(variables, jnp.asarray(mel))
    gen = port_models(HCFG, jax.tree.map(np.asarray, restored.gen_params), d)[0]
    with torch.no_grad():
        np.testing.assert_allclose(gen(torch.from_numpy(mel)).numpy(), np.asarray(want), rtol=0, atol=1e-5)
    after, metrics = jstep(restored, None, jnp.asarray(_batch(16, False)[1]))  # donates ``restored``
    assert int(after.step) == 2 and np.isfinite(float(metrics["gen_loss"]))


def test_port_resumes_jax_checkpoint(wavs, tmp_path, capsys, f32_step):
    """A JAX-written vocoder checkpoint after one JAX step: the port
    restores its parameters, spectral state, moments and counts, and
    ``train`` continues its step count."""
    jstep, tx = f32_step
    g, d, s = jax_gan_variables(HCFG, seed=18, frames=FRAMES, length=SEG)
    jstate, _ = jstep(_jax_state(tx, g, d, s), None, jnp.asarray(_batch(19, False)[1]))
    path = tmp_path / "hifigan_latest_ckpt.pickle"
    jax_train.save_vocoder_ckpt(path, jstate)

    cfg = _train_cfg(tmp_path, wavs)
    _, template, _, _ = _port_side(_cfg(), g, d, s)
    restored = port_train.restore_vocoder_state(path, template)
    assert restored.step == 1 and restored.gen_opt.count == 1 and restored.disc_opt.schedule_count == 1
    for named, tree in ((restored.gen_params, jstate.gen_params), (restored.disc_params, jstate.disc_params),
                        (restored.spectral, jstate.spectral), (restored.disc_opt.nu, jstate.disc_opt[0].nu)):
        got, want = _flat(ckpt.gan_tree(named)), _flat(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    state = port_train.train(cfg, wav_dir=wavs, num_steps=2, log_every=1, device="cpu")
    assert f"Resuming vocoder from {path} at step 1" in capsys.readouterr().out
    assert state.step == 2 and jax_ckpt.load_checkpoint(path)["step"] == 2


def test_disc_init_warm_start_and_mismatch(wavs, tmp_path, capsys):
    """``disc_init``: a fresh run starts from the donor's discriminators
    and ``u`` (one step moves a parameter by at most ~lr), and a tree that
    does not fit the configured discriminators fails loudly."""
    g, d, s = jax_gan_variables(HCFG, seed=20, frames=FRAMES, length=SEG)
    donor = tmp_path / "disc_init.pickle"
    port_train_ckpt.save_checkpoint(donor, {"format": ckpt.NATIVE_FORMAT, "step": 7, "disc_params": d, "spectral": s})
    cfg = _train_cfg(tmp_path / "run", wavs)
    state = port_train.train(cfg, wav_dir=wavs, num_steps=1, log_every=1, disc_init=donor, device="cpu")
    assert "Warm-starting discriminators" in capsys.readouterr().out
    got, want = _flat(ckpt.gan_tree(state.disc_params)), _flat(d)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=3 * LR, err_msg=k)

    bad = tmp_path / "disc_bad.pickle"
    port_train_ckpt.save_checkpoint(bad, {"format": ckpt.NATIVE_FORMAT, "step": 0,
                                          "disc_params": {"mpd": {}, "msd": {}}, "spectral": {}})
    with pytest.raises(ValueError, match="disc_params tree"):
        port_train.train(_train_cfg(tmp_path / "bad", wavs), wav_dir=wavs, num_steps=1, disc_init=bad, device="cpu")
    wrong = dataclasses.replace(HCFG, mpd_base_channels=8)
    _, d8, _ = jax_gan_variables(wrong, seed=21, frames=FRAMES, length=SEG)
    port_train_ckpt.save_checkpoint(bad, {"format": ckpt.NATIVE_FORMAT, "step": 0, "disc_params": d8, "spectral": s})
    with pytest.raises(ValueError, match="disc_params shapes mismatch"):
        port_train.train(_train_cfg(tmp_path / "bad", wavs), wav_dir=wavs, num_steps=1, disc_init=bad, device="cpu")


TINY_ARGS = [
    "--set", "train.batch_size=4", "--set", "train.ckpt_interval=1", "--set", "hifigan.segment_size=512",
    "--set", "hifigan.upsample_initial_channel=16", "--set", "hifigan.resblock_kernel_sizes=(3,)",
    "--set", "hifigan.mpd_periods=(2,3)", "--set", "hifigan.mpd_base_channels=4",
    "--set", "hifigan.msd_scales=1", "--set", "hifigan.msd_base_channels=16",
]


def test_entry_point_trains_on_cpu_and_resumes(wavs, tmp_path, capsys):
    """``main([... "--device", "cpu"])`` trains 2 steps (an in-loop
    checkpoint after each, written in the background) and JAX serves the
    result; a second run to 3 steps resumes at 2."""
    args = ["--wav-dir", str(wavs), "--ckpt-dir", str(tmp_path), "--device", "cpu", *TINY_ARGS]
    port_train.main(args + ["--steps", "2"])
    path = tmp_path / "hifigan_latest_ckpt.pickle"
    variables = jax_ckpt.load_variables(path, "hifigan")
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(variables))
    port_train.main(args + ["--steps", "3"])
    assert f"Resuming vocoder from {path} at step 2" in capsys.readouterr().out
    assert jax_ckpt.load_checkpoint(path)["step"] == 3


def test_entry_point_without_cuda_fails(wavs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.main(["--wav-dir", str(wavs), "--ckpt-dir", str(tmp_path), "--steps", "1", *TINY_ARGS])
