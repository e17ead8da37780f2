"""The port's HiFi-GAN step against the JAX trainer's, on the CPU, at the
tiny widths of ``test_torch_gan_models`` (segment 512, B=4).

* One whole ``make_gan_step`` against JAX's ``make_gan_step`` on one
  batch, audio-only and GTA modes: every loss within 1e-5 relative, the
  new spectral ``u`` within 1e-5, parameters after the step within 1e-6.
  Adam's first step is ``lr * g / (|g| + 1e-8)``: an element whose
  gradient is rounding noise around 0 moves by up to lr of either sign
  on each side, so there the sides may part by up to 2 lr, and only where
  the port's gradient is below 1e-4 of its leaf's largest.
* ``VocoderDataset`` crops bit-equal to JAX's for a seed (both modes);
  the adamw state tree both ways; the LR schedule with steps per epoch.

The bf16 step, checkpoints and the trainer are in
``test_torch_gan_ckpt.py`` (a second file, so that the JAX compiles of
the two spread over two workers).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from viettts_tpu.config import Config, TrainConfig
from viettts_tpu.data.audio import write_wav
from viettts_tpu.models import hifigan as jax_hifigan
from viettts_tpu.ops.mel import LogMelSpectrogram as JaxMel
from viettts_tpu.train import checkpoint as jax_ckpt
from viettts_tpu.train import hifigan as jax_train
from viettts_tpu_torch import checkpoint as ckpt
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.train import checkpoint as port_train_ckpt
from viettts_tpu_torch.train import common as port_common
from viettts_tpu_torch.train import hifigan as port_train

from test_torch_checkpoint import _flat
from test_torch_gan_models import HCFG, jax_gan_variables, port_models, port_spectral
from test_torch_pipeline import port_config

B, SEG, HOP, LR = 4, 512, 256, 2e-4
FRAMES = SEG // HOP
SR = 16000


def _cfg(mixed=False, h=HCFG, **train):
    return Config(hifigan=h, train=TrainConfig(batch_size=B, mixed_precision=mixed, **train))


class Recording(port_common.ClipAdamW):
    """The port's optimizer, keeping the last gradients it was given."""

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return super().update(grads, state, params)


def _jax_side(cfg):
    h = cfg.hifigan
    gen = jax_hifigan.Generator(h, use_wn=True, dtype=jnp.bfloat16 if cfg.train.mixed_precision else jnp.float32)
    mpd = jax_hifigan.MultiPeriodDiscriminator(periods=h.mpd_periods, base_channels=h.mpd_base_channels)
    msd = jax_hifigan.MultiScaleDiscriminator(num_scales=h.msd_scales, base_channels=h.msd_base_channels)
    lr = optax.exponential_decay(LR, 3, h.lr_decay, staircase=True)
    tx = optax.adamw(lr, b1=h.adam_b1, b2=h.adam_b2)
    return jax_train.make_gan_step(cfg, gen, mpd, msd, tx, tx, JaxMel(cfg.dsp)), tx


def _jax_state(tx, gen_params, disc_params, spectral):
    g, d = jax.tree.map(jnp.asarray, gen_params), jax.tree.map(jnp.asarray, disc_params)
    return jax_train.GanState(jnp.asarray(0, jnp.int32), g, d, jax.tree.map(jnp.asarray, spectral),
                              tx.init(g), tx.init(d), jax.random.PRNGKey(0))


def _port_side(cfg, gen_params, disc_params, spectral, opt_cls=port_common.ClipAdamW):
    pcfg = port_config(cfg)
    h = pcfg.hifigan
    gen, discs = port_models(cfg.hifigan, gen_params, disc_params,
                             torch.bfloat16 if cfg.train.mixed_precision else torch.float32)
    lr = port_common.exponential_decay(LR, 3, h.lr_decay, staircase=True)
    gen_tx, disc_tx = (opt_cls(lr, None, 1e-4, h.adam_b1, h.adam_b2) for _ in range(2))
    gp, dp = dict(gen.named_parameters()), dict(discs.named_parameters())
    state = port_train.GanState(0, gp, dp, port_spectral(discs, spectral), gen_tx.init(gp), disc_tx.init(dp),
                                np.zeros(2, np.uint32))
    step = port_train.make_gan_step(pcfg, gen, discs, gen_tx, disc_tx, LogMelSpectrogram(pcfg.dsp))
    return step, state, (gen_tx, disc_tx), (gen, discs)


def _batch(seed, gta):
    rng = np.random.RandomState(seed)
    audio = (0.3 * rng.randn(B, SEG)).astype(np.float32)
    mel = (rng.randn(B, FRAMES, 80) - 4.0).astype(np.float32) if gta else None
    return mel, audio


@pytest.fixture(scope="module")
def f32_step():
    """JAX's step function and optimizer at the f32 tiny config, compiled once."""
    return _jax_side(_cfg())


def _assert_params_after_step(port_named, jax_tree, grads):
    got = _flat(ckpt.gan_tree(port_named))
    want = _flat(jax_tree)
    assert sorted(got) == sorted(want)
    grad_tree = _flat(ckpt.gan_tree(grads))
    drifted = 0
    for k, w in want.items():
        w = np.asarray(w)
        diff = np.abs(got[k] - w)
        off = diff > 1e-6
        if off.any():
            g = np.abs(grad_tree[k])
            assert diff.max() <= 2 * LR * 1.01, (k, diff.max())
            assert (g[off] <= 1e-4 * g.max()).all(), (k, g[off].max(), g.max())
            drifted += int(off.sum())
    assert drifted <= 1e-3 * sum(a.size for a in want.values())


@pytest.mark.parametrize("mode", ["audio", "gta"])
def test_gan_step_matches_jax(mode, f32_step):
    cfg = _cfg(h=HCFG)
    gen_params, disc_params, spectral = jax_gan_variables(HCFG, seed=11, frames=FRAMES, length=SEG)
    jstep, tx = f32_step
    mel, audio = _batch(12, mode == "gta")
    jstate, jm = jstep(_jax_state(tx, gen_params, disc_params, spectral),
                       None if mel is None else jnp.asarray(mel), jnp.asarray(audio))
    pstep, pstate, (gen_tx, disc_tx), _ = _port_side(cfg, gen_params, disc_params, spectral, Recording)
    pstate, pm = pstep(pstate, None if mel is None else torch.from_numpy(mel), torch.from_numpy(audio))
    for k in port_train.METRICS:
        got, want = float(pm[k]), float(jm[k])
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    assert pstate.step == int(jstate.step) == 1
    want_u = ckpt.named_from_gan_tree(jstate.spectral, list(pstate.spectral))
    for k, w in want_u.items():
        np.testing.assert_allclose(pstate.spectral[k].numpy(), w, rtol=0, atol=1e-5, err_msg=k)
    _assert_params_after_step(pstate.gen_params, jstate.gen_params, gen_tx.grads)
    _assert_params_after_step(pstate.disc_params, jstate.disc_params, disc_tx.grads)
    adam = jstate.gen_opt[0]
    assert pstate.gen_opt.count == int(adam.count) == 1 and pstate.gen_opt.schedule_count == 1


# ---------------------------------------------------------------------------
# Data, optimizer tree, schedule.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Six int16 WAVs of 0.03-1.3 s (one shorter than a segment), and GTA
    mels for five of them, two too short to crop: three usable pairs."""
    d = tmp_path_factory.mktemp("wavs")
    gta = d / "gta"
    gta.mkdir()
    rng = np.random.RandomState(0)
    for i, n in enumerate((16000, 3200, 20800, 9000, 400, 12345)):
        write_wav(d / f"utt{i:02d}.wav", (rng.randn(n) * 3000).astype(np.int16), SR)
        if i != 2:
            frames = 2 if i == 3 else n // HOP + 1
            np.save(gta / f"utt{i:02d}.npy", rng.randn(80, frames).astype(np.float32))
    return d


@pytest.mark.parametrize("mode", ["audio", "gta"])
def test_vocoder_dataset_crops_match_jax(mode, wavs):
    gta = wavs / "gta" if mode == "gta" else None
    jds = jax_train.VocoderDataset(wavs, SEG, HOP, gta_dir=gta)
    pds = port_train.VocoderDataset(wavs, SEG, HOP, gta_dir=gta)
    assert len(pds) == len(jds) == (3 if gta else 6)
    batches = zip(*(ds.batches(5, seed=3) for ds in (jds, pds)))
    for (jm, ja), (pm, pa) in itertools.islice(batches, 3):
        np.testing.assert_array_equal(pa, ja)
        assert (pm is None) == (jm is None) == (gta is None)
        if gta is not None:
            np.testing.assert_array_equal(pm, jm)


def test_adamw_state_tree_round_trips_through_optax(tmp_path):
    """The GAN optimizer's state (no clipping) pickles as optax's
    ``adamw`` tree over the nested parameter tree: JAX reads it with the
    same structure as ``tx.init`` and the port reads it back bit-exact."""
    gen_params, disc_params, spectral = jax_gan_variables(HCFG, seed=15, frames=FRAMES, length=SEG)
    _, state, (gen_tx, _), _ = _port_side(_cfg(), gen_params, disc_params, spectral)
    names = list(state.gen_params)
    grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) for i, (k, p) in
             enumerate(state.gen_params.items())}
    opt = gen_tx.update(grads, state.gen_opt, state.gen_params)
    tree = port_common.opt_state_to_optax(opt, clipped=False, to_tree=ckpt.gan_tree)
    port_train_ckpt.save_checkpoint(tmp_path / "opt.pickle", {"opt": tree})
    loaded = jax_ckpt.load_checkpoint(tmp_path / "opt.pickle")["opt"]
    tx = optax.adamw(optax.exponential_decay(LR, 3, 0.999, staircase=True), b1=0.8, b2=0.99)
    assert jax.tree.structure(loaded) == jax.tree.structure(tx.init(gen_params))
    mine = port_train_ckpt.load_checkpoint(tmp_path / "opt.pickle")["opt"]
    back = port_common.opt_state_from_optax(mine, state.gen_params, ckpt.named_from_gan_tree)
    assert back.count == opt.count == 1 and back.schedule_count == opt.schedule_count == 1
    for k in names:
        assert torch.equal(back.mu[k], opt.mu[k]) and torch.equal(back.nu[k], opt.nu[k]), k


@pytest.mark.parametrize("count", [0, 1, 2, 3, 7, 3000])
def test_exponential_decay_per_epoch_matches_optax(count):
    """The GAN schedule: ``lr_decay`` once per epoch of 3 steps."""
    want = optax.exponential_decay(2e-4, 3, 0.999, staircase=True)(count)
    assert port_common.exponential_decay(2e-4, 3, 0.999, staircase=True)(count) == float(want)
