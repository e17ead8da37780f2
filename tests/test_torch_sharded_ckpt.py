"""The port's sharded training checkpoint (``checkpoint_format="orbax"``:
a ``torch.distributed.checkpoint`` directory ``<stem>.dcp`` beside the
pickle path) on the CPU without a process group, at the tiny widths of
``test_torch_train`` and ``test_torch_gan_models``:

* one state saved in both formats restores to the same bits (parameters,
  statistics, moments, counts, step and generator state) for the duration
  and acoustic trainers and the GAN's raw state;
* a JAX-written pickle goes through the port into the sharded format and
  back out to a pickle that JAX's ``restore_state`` /
  ``restore_vocoder_state`` reads equal to the original;
* the duration trainer resumes from the directory with the losses of the
  pickle run, writing no pickle (``tests/test_trainers.py``'s Orbax test);
* a JAX ``<stem>.orbax`` directory alone raises instead of starting fresh;
* the GAN trainer keeps only the folded params in the pickle, which
  ``Synthesizer`` serves, and resumes from the directory;
* the directory is replaced atomically.

Restores across world sizes are in ``test_torch_multihost.py``.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viettts_tpu.train import checkpoint as jax_ckpt
from viettts_tpu.train import common as jax_common
from viettts_tpu.train import duration as jax_duration
from viettts_tpu.train import hifigan as jax_train
from viettts_tpu_torch.data.loader import to_device
from viettts_tpu_torch.infer.pipeline import Synthesizer
from viettts_tpu_torch.models.hifigan import Generator as PortGenerator
from viettts_tpu_torch.train import checkpoint as port_ckpt
from viettts_tpu_torch.train import common as port_common
from viettts_tpu_torch.train import duration as port_duration
from viettts_tpu_torch.train import hifigan as port_train

from test_torch_gan_ckpt import _train_cfg
from test_torch_gan_models import HCFG, jax_gan_variables
from test_torch_gan_train import FRAMES, SEG, _batch, _cfg, _jax_side, _jax_state, _port_side, wavs  # noqa: F401
from test_torch_pipeline import _cfg as pipeline_cfg
from test_torch_pipeline import _write_checkpoints, port_config
from test_torch_train import ACOUSTIC, DURATION, LR, Pair, _batches, corpus  # noqa: F401

CONFIGS = {"duration": DURATION, "acoustic": ACOUSTIC}


def _optimizer(kind):
    """The duration trainer's constant rate; the acoustic one under a
    schedule, so that the schedule's count goes through the files too."""
    lr = LR if kind == "duration" else port_common.exponential_decay(LR, 3, 0.5, staircase=True)
    return port_common.make_optimizer(lr, 1.0, 1e-4)


def _trained_state(kind, seed=0):
    """A port train state after two steps, its generator drawn past its seed."""
    pair = Pair(kind, CONFIGS[kind], seed=seed)
    opt = _optimizer(kind)
    update = port_common.make_update_fn(pair.port_loss, opt)
    state = pair.port_state(opt)
    for b in _batches(6 + seed, 2):
        state, _ = update(state, [to_device(pair.batch(b), torch.device("cpu"))])
    torch.rand(5, generator=state.rng)
    return state


def _generator_draw(g):
    return torch.rand(4, generator=torch.Generator().set_state(g.get_state()))


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("kind", ["duration", "acoustic"])
def test_both_formats_restore_the_same_state(kind, tmp_path):
    """The same trained state through the pickle and through the sharded
    directory: each restores, into another model's tensors, the state's
    bits, so the two agree."""
    state = _trained_state(kind)
    want_draw = _generator_draw(state.rng)
    for fmt in ("pickle", "orbax"):
        path = tmp_path / fmt / f"{kind}_latest_ckpt.pickle"
        port_duration.save_native_ckpt(path, state, fmt)
        written = sorted(p.name for p in path.parent.iterdir())
        assert written == [path.name if fmt == "pickle" else f"{kind}_latest_ckpt.dcp"]
        opt = _optimizer(kind)
        template = Pair(kind, CONFIGS[kind], seed=1).port_state(opt)
        restored = port_duration.restore_state(path, opt, template, fmt)
        assert restored.step == state.step == 2
        assert restored.opt_state.count == 2
        assert restored.opt_state.schedule_count == (None if kind == "duration" else 2)
        _assert_same(restored.params, state.params)
        _assert_same(restored.batch_stats, state.batch_stats)
        _assert_same(restored.opt_state.mu, state.opt_state.mu)
        _assert_same(restored.opt_state.nu, state.opt_state.nu)
        assert all(restored.params[k] is template.params[k] for k in state.params)  # the model's own tensors
        torch.testing.assert_close(_generator_draw(restored.rng), want_draw, rtol=0, atol=0)


def _gan_state(seed):
    """A port GAN state after one step, with a non-zero key."""
    g, d, s = jax_gan_variables(HCFG, seed=seed, frames=FRAMES, length=SEG)
    step, state, _, _ = _port_side(_cfg(), g, d, s)
    state, _ = step(state, None, torch.from_numpy(_batch(seed + 1, False)[1]))
    return state._replace(rng=np.asarray([seed, 2**32 - 1 - seed], np.uint32))


def _assert_same_gan(got, want):
    assert got.step == want.step and np.array_equal(got.rng, want.rng) and got.rng.dtype == np.uint32
    for name in ("gen_params", "disc_params", "spectral"):
        _assert_same(getattr(got, name), getattr(want, name))
    for name in ("gen_opt", "disc_opt"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a.count, a.schedule_count) == (b.count, b.schedule_count)
        _assert_same(a.mu, b.mu)
        _assert_same(a.nu, b.nu)


def test_both_formats_restore_the_same_gan_state(tmp_path):
    """The GAN's raw state (generator, MPD and MSD parameters, spectral
    ``u``, both optimizers and the key) through both formats restores the
    same bits into another model's tensors; the sharded format's pickle
    holds the folded generator alone."""
    state = _gan_state(30)
    for fmt in ("pickle", "orbax"):
        path = tmp_path / fmt / "hifigan_latest_ckpt.pickle"
        port_train.save_vocoder_ckpt(path, state, fmt=fmt)
        dic = jax_ckpt.load_checkpoint(path)
        assert sorted(dic) == (["format", "raw", "step", "variables"] if fmt == "pickle"
                               else ["format", "step", "variables"])
        assert port_ckpt.sharded_dir(path).exists() == (fmt == "orbax")
        template = _gan_state(31)
        restored = port_train.restore_vocoder_state(path, template, fmt=fmt)
        _assert_same_gan(restored, state)
        assert all(restored.gen_params[k] is template.gen_params[k] for k in state.gen_params)


def _seeded_like(tree, rng):
    """``tree`` with every float leaf replaced by seeded values (the
    optimizer's moments, nonzero) and every integer leaf (its counts) by
    ascending small numbers."""
    counts = iter(range(3, 100))

    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return jnp.asarray(rng.randn(*a.shape).astype(a.dtype))
        return jnp.asarray(next(counts), a.dtype)

    return jax.tree.map(leaf, tree)


def _assert_jax_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["duration", "acoustic"])
def test_jax_pickle_round_trips_through_the_sharded_format(kind, tmp_path):
    """A JAX-written training pickle (seeded moments and counts, a
    non-zero key): the port restores it, saves it in the sharded format,
    restores that into another model and writes a pickle again, which
    JAX's ``restore_state`` reads equal to the original."""
    pair = Pair(kind, CONFIGS[kind])
    jopt = jax_common.make_optimizer(LR, 1.0, 1e-4)
    jstate = pair.jax_state(jopt)
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32), rng=jax.random.PRNGKey(1234),
                             opt_state=_seeded_like(jstate.opt_state, np.random.RandomState(3)))
    src, mid, out = (tmp_path / d / f"{kind}_latest_ckpt.pickle" for d in ("jax", "sharded", "port"))
    jax_duration.save_native_ckpt(src, jstate)
    opt = port_common.make_optimizer(LR, 1.0, 1e-4)
    state = port_duration.restore_state(src, opt, pair.port_state(opt))
    port_duration.save_native_ckpt(mid, state, "orbax")
    opt = port_common.make_optimizer(LR, 1.0, 1e-4)
    again = port_duration.restore_state(mid, opt, Pair(kind, CONFIGS[kind], seed=1).port_state(opt), "orbax")
    port_duration.save_native_ckpt(out, again)
    got = jax_duration.restore_state(out, jopt, pair.jax_state(jopt))
    _assert_jax_equal(got, jstate)


def test_jax_gan_pickle_round_trips_through_the_sharded_format(tmp_path):
    """The same for a JAX-written vocoder checkpoint: its raw state through
    the port's sharded directory and back to a pickle that JAX's
    ``restore_vocoder_state`` reads equal to the original."""
    _, tx = _jax_side(_cfg())
    g, d, s = jax_gan_variables(HCFG, seed=40, frames=FRAMES, length=SEG)
    jstate = _jax_state(tx, g, d, s)
    rng = np.random.RandomState(41)
    jstate = jstate._replace(step=jnp.asarray(9, jnp.int32), gen_opt=_seeded_like(jstate.gen_opt, rng),
                             disc_opt=_seeded_like(jstate.disc_opt, rng), rng=jax.random.PRNGKey(77))
    src, mid, out = (tmp_path / d / "hifigan_latest_ckpt.pickle" for d in ("jax", "sharded", "port"))
    jax_train.save_vocoder_ckpt(src, jstate)
    state = port_train.restore_vocoder_state(src, _gan_state(42))
    port_train.save_vocoder_ckpt(mid, state, fmt="orbax")
    again = port_train.restore_vocoder_state(mid, _gan_state(43), fmt="orbax")
    port_train.save_vocoder_ckpt(out, again)
    g2, d2, s2 = jax_gan_variables(HCFG, seed=44, frames=FRAMES, length=SEG)
    got = jax_train.restore_vocoder_state(out, _jax_state(tx, g2, d2, s2))
    _assert_jax_equal(got, jstate)


def _duration_cfg(corpus_dir, ckpt_dir, steps, fmt):
    from viettts_tpu_torch.config import Config, DataConfig, DurationModelConfig, TrainConfig

    return Config(data_dir=corpus_dir, ckpt_dir=ckpt_dir, data=DataConfig(max_phoneme_seq_len=64),
                  duration=DurationModelConfig(lstm_dim=16),
                  train=TrainConfig(batch_size=4, num_training_steps=steps, val_interval=1, ckpt_interval=1,
                                    checkpoint_format=fmt))


def test_duration_trainer_sharded_checkpoint_resume(corpus, tmp_path, capsys):  # noqa: F811
    """``checkpoint_format="orbax"`` writes the directory and no pickle,
    and a second run resumes from it: every loss of 2 + 2 steps equals the
    pickle-format run's (both resumed runs restart the batch stream, as
    JAX's trainers do)."""
    losses = {}
    for fmt in ("pickle", "orbax"):
        log = []
        state = port_duration.train(_duration_cfg(corpus, tmp_path / fmt, 2, fmt), device="cpu", step_log=log)
        assert state.step == 2
        names = sorted(p.name for p in (tmp_path / fmt).iterdir())
        assert names == (["duration_latest_ckpt.pickle"] if fmt == "pickle" else ["duration_latest_ckpt.dcp"])
        state = port_duration.train(_duration_cfg(corpus, tmp_path / fmt, 4, fmt), device="cpu", step_log=log)
        assert state.step == 4
        assert "at step 2" in capsys.readouterr().out
        losses[fmt] = [loss for _, loss in log]
    assert len(losses["orbax"]) == 4 and losses["orbax"] == losses["pickle"]


@pytest.mark.parametrize("kind", ["duration", "hifigan"])
def test_jax_orbax_directory_alone_raises(kind, corpus, tmp_path):  # noqa: F811
    """Where only JAX's ``<stem>.orbax`` directory exists, resuming in the
    sharded format names it and the way across (the pickle) rather than
    starting fresh."""
    jax_ckpt.save_checkpoint_orbax(tmp_path / f"{kind}_latest_ckpt.orbax", {"step": np.asarray(3, np.int32)})
    with pytest.raises(ValueError, match=rf"{kind}_latest_ckpt.orbax is the JAX package's Orbax checkpoint"):
        if kind == "duration":
            port_duration.train(_duration_cfg(corpus, tmp_path, 1, "orbax"), device="cpu")
        else:
            port_train.restore_vocoder_state(tmp_path / "hifigan_latest_ckpt.pickle", _gan_state(50), fmt="orbax")


def test_sharded_gan_checkpoint_serves_and_resumes(wavs, tmp_path, capsys):  # noqa: F811
    """The GAN trainer in the sharded format, 2 steps with a checkpoint
    after each (the first written from the background thread): the
    directory holds the raw state, the pickle the folded generator alone,
    which ``Synthesizer`` serves on the CPU as the trained weight-normalized
    generator computes; a run to 3 steps resumes at 2."""
    run = tmp_path / "gan"
    cfg = _train_cfg(run, wavs, checkpoint_format="orbax", ckpt_interval=1)
    state = port_train.train(cfg, wav_dir=wavs, num_steps=2, log_every=1, device="cpu")
    path = run / "hifigan_latest_ckpt.pickle"
    assert sorted(p.name for p in run.iterdir()) == ["hifigan_latest_ckpt.dcp", path.name]
    assert sorted(jax_ckpt.load_checkpoint(path)) == ["format", "step", "variables"]

    jcfg = pipeline_cfg().replace(hifigan=dataclasses.replace(HCFG, fused_inference=False, inference_dtype="float32"))
    serve = _write_checkpoints(jcfg, tmp_path / "serve")
    shutil.copy(path, serve / path.name)
    synth = Synthesizer(port_config(jcfg.replace(ckpt_dir=serve)), device="cpu")
    assert np.isfinite(synth.synthesize("xin chào").wave).all()
    wn = PortGenerator(port_config(HCFG), use_wn=True)
    with torch.no_grad():
        for k, p in wn.named_parameters():
            p.copy_(state.gen_params[k])
    mel = np.random.RandomState(51).randn(2, 6, 80).astype(np.float32)
    with torch.no_grad():
        want = wn(torch.from_numpy(mel))[..., 0].numpy()
    np.testing.assert_allclose(synth.vocode(mel), want, rtol=0, atol=1e-5)

    capsys.readouterr()
    port_train.train(cfg, wav_dir=wavs, num_steps=3, log_every=1, device="cpu")
    assert "Resuming vocoder from" in capsys.readouterr().out
    assert jax_ckpt.load_checkpoint(path)["step"] == 3


def test_sharded_save_replaces_the_directory_atomically(tmp_path):
    """A second save replaces the first and leaves no ``.tmp`` or ``.old``
    behind, whatever a failed save left; a save stopped between its two
    renames leaves the previous directory as ``.old``, which loads."""
    d = port_ckpt.sharded_dir(tmp_path / "x_latest_ckpt.pickle")
    assert d.name == "x_latest_ckpt.dcp"
    port_ckpt.save_sharded(d, {"w": torch.arange(6.0), "step": torch.tensor(1)})
    stale = d.with_name(d.name + ".tmp")
    stale.mkdir()
    (stale / "__7_0.distcp").write_bytes(b"left by a failed save")
    port_ckpt.save_sharded(d, {"w": torch.arange(6.0) + 1, "step": torch.tensor(2)})
    assert sorted(p.name for p in tmp_path.iterdir()) == [d.name]
    got = port_ckpt.load_sharded(d, {"w": torch.zeros(6), "step": torch.tensor(0)})
    assert int(got["step"]) == 2 and torch.equal(got["w"], torch.arange(6.0) + 1)
    d.rename(d.with_name(d.name + ".old"))
    got = port_ckpt.load_sharded(d, {"w": torch.zeros(6), "step": torch.tensor(0)})
    assert int(got["step"]) == 2
    assert port_ckpt.load_sharded(tmp_path / "missing.dcp", {"w": torch.zeros(6)}) is None

