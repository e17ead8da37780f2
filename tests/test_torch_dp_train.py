"""Data-parallel and FSDP training of the port on 2 ranks against one
process on the whole batch, on the CPU with ``gloo`` (the counterpart of
``tests/test_dp_equivalence.py`` and ``tests/test_multihost.py``).

The file runs itself as the two ranks, once, in a module fixture: each
joins the group through ``initialize_distributed("file://...", 2, rank,
device="cpu")``, runs every check below on its rows of the global batches
and writes its results; the single-process reference runs meanwhile in
the test process.  At ``test_dp_equivalence``'s config (acoustic encoder
and decoder 16, prenet 8, postnet 8; B=8 in 2 updates x 2
``steps_per_update``), with every dropout, zoneout and token masking on
and ragged waveform lengths, so that the masked loss's global denominator
matters:

* gradients within 1e-6 of one process's;
* SGD + global-norm clip: parameters within 1e-6, losses at rtol 1e-5;
* AdamW: the loss trajectory at rtol 1e-5;
* FSDP (``min_size=256``): SGD + clip parameters within 1e-6, and AdamW's
  moments gathered from the shards within 1e-5 of each leaf's largest
  (they are sums of gradients that agree to reassociation noise), and
  within 1e-6 on the conv biases that feed a BatchNorm, whose gradient is
  zero in exact arithmetic and rounding noise on either side; between
  steps each rank holds half of every split leaf's parameter and moments;
* every rank's parameters bitwise equal to the other's;
* the duration trainer's ``train()`` for 2 steps: the losses of one
  process at rtol 1e-5, one checkpoint, which JAX's ``load_variables``
  reads; under ``train.fsdp`` (LSTM width 128, whose gate matrices split)
  the same losses, the parameters of the 2-rank run without FSDP within
  1e-6 (AdamW's steps on rounding-noise gradients excepted, as in
  ``tests/test_torch_gan_train.py``), half of each split leaf resident on
  each rank after training, and a checkpoint of whole trees that one
  process and JAX's ``restore_state`` take;
* ``make_gan_step`` (audio mode): losses within 1e-5 relative, the
  spectral ``u`` within 1e-6, and bitwise equal across the ranks.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
B, T_TOKENS, S, SR = 8, 8, 4096, 16000
STEPS_PER_UPDATE, NUM_UPDATES = 2, 2
WORLD = 2
TIMEOUT_S = 120
FSDP_LSTM_DIM = 128  # the LSTM gate matrices ([128, 512]) reach FSDP's 2**16-element split size


# ---------------------------------------------------------------------------
# The checks, run by each rank (data_parallel=True) and by one process.
# ---------------------------------------------------------------------------


def _acoustic_batch(seed: int):
    from viettts_tpu_torch.types import AcousticBatch

    rng = np.random.RandomState(seed)
    return AcousticBatch(
        phonemes=np.asarray(rng.randint(0, 93, (B, T_TOKENS)), np.int32),
        lengths=np.asarray([T_TOKENS] * B, np.int32),
        durations=np.full((B, T_TOKENS), S / SR / T_TOKENS, np.float32),
        wavs=(rng.randn(B, S) * 2000).astype(np.int16),
        wav_lengths=np.asarray(rng.randint(S // 4, S + 1, B), np.int32),
        mels=None,
    )


class ClipSGD:
    """optax's ``chain(clip_by_global_norm(1.0), sgd(0.05))`` with the
    port optimizers' interface."""

    max_grad_norm = 1.0

    def init(self, params):
        from viettts_tpu_torch.train.common import AdamWState

        return AdamWState(0, {}, {}, None)

    @torch.no_grad()
    def update(self, grads, state, params, g_norm=None):
        if g_norm is None:
            g_norm = torch.stack([torch.sum(g * g) for g in grads.values()]).sum().sqrt()
        for k, p in params.items():
            g = torch.where(g_norm < self.max_grad_norm, grads[k], grads[k] / g_norm * self.max_grad_norm)
            p.sub_(0.05 * g)
        return state._replace(count=state.count + 1)


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _resident(params, opt_state):
    """What a rank holds of each parameter between steps: (elements of the
    parameter, bytes of its storage, elements of its two moments)."""
    return {k: (p.numel(), p.untyped_storage().nbytes(), opt_state.mu[k].numel() if opt_state.mu else None,
                opt_state.nu[k].numel() if opt_state.nu else None) for k, p in params.items()}


def acoustic_checks(dp: bool) -> dict:
    """Gradients, SGD + clip, AdamW and FSDP runs of the acoustic loss."""
    from viettts_tpu_torch.config import AcousticModelConfig, DspConfig
    from viettts_tpu_torch.data.loader import to_device
    from viettts_tpu_torch.models.acoustic import AcousticModel
    from viettts_tpu_torch.models.layers import batch_stats
    from viettts_tpu_torch.ops.mel import LogMelSpectrogram
    from viettts_tpu_torch.parallel import mesh
    from viettts_tpu_torch.train import acoustic
    from viettts_tpu_torch.train.common import (
        FsdpClipAdamW,
        init_train_state,
        make_optimizer,
        make_update_fn,
        whole_opt_state,
        whole_params,
    )

    cpu = torch.device("cpu")
    model = AcousticModel(AcousticModelConfig(encoder_dim=16, decoder_dim=16, prenet_dim=8, postnet_dim=8))
    model.init_params(torch.Generator().manual_seed(0))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    dsp = DspConfig()
    loss_fn = acoustic.make_loss_fn(model, LogMelSpectrogram(dsp), dsp.hop_length, train=True)

    def rows(batch):
        return to_device(mesh.shard_batch(batch) if dp else batch, cpu)

    out = {}
    params = dict(model.named_parameters())
    with mesh.data_parallel() if dp else contextlib.nullcontext():
        loss, _ = loss_fn(params, batch_stats(model), torch.Generator().manual_seed(7), rows(_acoustic_batch(0)))
        grads = torch.autograd.grad(loss, list(params.values()))
    if dp:
        grads = mesh.all_reduce_grads(grads)
    out["grads"] = {k: g.numpy().copy() for k, g in zip(params, grads)}

    def run(optimizer, fsdp=False):
        trained = AcousticModel(model.cfg)  # FSDP splits its parameters at rest; loss_fn reads the dicts
        trained.load_state_dict(initial)
        if fsdp:
            optimizer = FsdpClipAdamW(optimizer, min_size=256)
        state = init_train_state(dict(trained.named_parameters()), batch_stats(trained), optimizer,
                                 torch.Generator().manual_seed(42))
        update = make_update_fn(loss_fn, optimizer, data_parallel=dp)
        losses = []
        for u in range(NUM_UPDATES):
            state, loss = update(state, [rows(_acoustic_batch(10 * u + s)) for s in range(STEPS_PER_UPDATE)])
            losses.append(float(loss))
        moments = whole_opt_state(optimizer, state.opt_state)
        out = {"params": _numpy(whole_params(optimizer, state.params)), "stats": _numpy(state.batch_stats),
               "losses": losses, "mu": _numpy(moments.mu), "nu": _numpy(moments.nu)}
        if fsdp:  # what each rank holds between steps
            out["resident"] = _resident(state.params, state.opt_state)
        return out

    out["sgd"] = run(ClipSGD())
    out["adamw"] = run(make_optimizer(1e-3))
    if dp:
        out["fsdp_sgd"] = run(ClipSGD(), fsdp=True)
        out["fsdp_adamw"] = run(make_optimizer(1e-3), fsdp=True)
        w = mesh.world()[1]
        out["fsdp_axes"] = {k: mesh.fsdp_shard_axis(tuple(p.shape), w, 256) for k, p in params.items()}
    return out


def duration_trainer(dp: bool, corpus: Path, ckpt_dir: Path, fsdp: bool = False, lstm_dim: int = 16) -> dict:
    """``train.duration.train`` for 2 steps at tiny widths, token masking
    and dropout on; with ``fsdp`` what each rank holds after it."""
    from viettts_tpu_torch.config import Config, DataConfig, DurationModelConfig, TrainConfig
    from viettts_tpu_torch.train import duration

    cfg = Config(
        data_dir=corpus, ckpt_dir=ckpt_dir,
        data=DataConfig(max_phoneme_seq_len=64),
        duration=DurationModelConfig(lstm_dim=lstm_dim),
        train=TrainConfig(batch_size=4, num_training_steps=2, val_interval=1, ckpt_interval=1,
                          num_devices=WORLD if dp else -1, fsdp=fsdp),
    )
    log = []
    state = duration.train(cfg, device="cpu", step_log=log)
    out = {"losses": [loss for _, loss in log]}
    if fsdp:
        out["resident"] = _resident(state.params, state.opt_state)
    else:
        out["params"] = _numpy(state.params)
    return out


def gan_checks(dp: bool) -> dict:
    """One ``make_gan_step`` from the trainer's seeded cold init, audio
    mode, B=4, segment 512."""
    from viettts_tpu_torch.config import Config, HifiGanConfig, TrainConfig
    from viettts_tpu_torch.parallel import mesh
    from viettts_tpu_torch.train.hifigan import build_gan

    cfg = Config(hifigan=HifiGanConfig(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                                       resblock_dilation_sizes=((1, 3),), segment_size=512, mpd_periods=(2, 3),
                                       mpd_base_channels=4, msd_scales=2, msd_base_channels=16),
                 train=TrainConfig(batch_size=4))
    audio = (np.random.default_rng(5).standard_normal((4, 512)) * 0.3).astype(np.float32)
    if dp:
        audio = mesh.shard_batch(audio)
    state, step = build_gan(cfg, "cpu", 2e-4, data_parallel=dp)
    state, metrics = step(state, None, torch.from_numpy(np.ascontiguousarray(audio)))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "u": _numpy(state.spectral),
            "gen": _numpy(state.gen_params)}


def run_all(dp: bool, corpus: Path, ckpt_dir: Path) -> dict:
    out = {"acoustic": acoustic_checks(dp), "duration": duration_trainer(dp, corpus, ckpt_dir),
           "duration_wide": duration_trainer(dp, corpus, ckpt_dir.with_name(ckpt_dir.name + "_wide"),
                                             lstm_dim=FSDP_LSTM_DIM),
           "gan": gan_checks(dp)}
    if dp:
        out["duration_fsdp"] = duration_trainer(dp, corpus, ckpt_dir.with_name(ckpt_dir.name + "_fsdp"), fsdp=True,
                                                lstm_dim=FSDP_LSTM_DIM)
    return out


def worker(store: str, rank: int, corpus: Path, out_dir: Path) -> None:
    import pickle

    import torch.distributed as dist

    from viettts_tpu_torch.parallel import mesh

    torch.set_num_threads(1)  # one reduction order, run to run
    device = mesh.initialize_distributed(store, WORLD, rank, device="cpu")
    results = run_all(True, corpus, out_dir / "ckpt")
    results["group"] = {"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
                        "device": str(device)}
    dist.destroy_process_group()
    with open(out_dir / f"rank{rank}.pickle", "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import pickle

    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from validate_e2e_training import build_corpus
    finally:
        sys.path.remove(str(REPO / "scripts"))
    tmp = tmp_path_factory.mktemp("dp_train")
    corpus = tmp / "corpus"
    corpus.mkdir()
    build_corpus(corpus, n_utts=24, seed=0)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen([sys.executable, __file__, f"file://{tmp / 'store'}", str(r), str(corpus), str(tmp)],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)  # one reduction order, run to run
        try:
            single = run_all(False, corpus, tmp / "single")
        finally:
            torch.set_num_threads(threads)
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pickle", "rb") as f:
            ranks.append(pickle.load(f))
    return {"single": single, "ranks": ranks, "dir": tmp}


def _max_delta(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def test_two_process_group_forms(runs):
    """``initialize_distributed(coordinator, 2, pid)``: both processes in
    one gloo group on the CPU."""
    groups = [r["group"] for r in runs["ranks"]]
    assert [g["rank"] for g in groups] == [0, 1]
    assert all(g["world"] == 2 and g["backend"] == "gloo" and g["device"] == "cpu" for g in groups)


def test_dp_gradients_match_single_device(runs):
    assert _max_delta(runs["ranks"][0]["acoustic"]["grads"], runs["single"]["acoustic"]["grads"]) < 1e-6


def test_dp_sgd_params_match_single_device(runs):
    one, two = runs["single"]["acoustic"]["sgd"], runs["ranks"][0]["acoustic"]["sgd"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5, atol=1e-6)
    assert _max_delta(two["params"], one["params"]) < 1e-6
    assert _max_delta(two["stats"], one["stats"]) < 1e-6


def test_dp_adamw_loss_trajectory_matches(runs):
    one, two = runs["single"]["acoustic"]["adamw"], runs["ranks"][0]["acoustic"]["adamw"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5, atol=1e-6)


def test_fsdp_matches_single_device(runs):
    """SGD + clip under FSDP reaches one process's parameters; some leaves
    were split, and AdamW's moments gathered from the shards are one
    process's."""
    acoustic = runs["ranks"][0]["acoustic"]
    assert any(a is not None for a in acoustic["fsdp_axes"].values())
    assert any(a is None for a in acoustic["fsdp_axes"].values())
    one, two = runs["single"]["acoustic"]["sgd"], acoustic["fsdp_sgd"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5, atol=1e-6)
    assert _max_delta(two["params"], one["params"]) < 1e-6
    one, two = runs["single"]["acoustic"]["adamw"], acoustic["fsdp_adamw"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5, atol=1e-6)
    zero_grad = {f"encoder.convs.{i}.bias" for i in range(3)} | {f"postnet_convs.{i}.bias" for i in range(4)}
    for m in ("mu", "nu"):
        for k, want in one[m].items():
            bar = 1e-6 if k in zero_grad else 1e-5 * max(np.max(np.abs(want)), 1e-30)
            assert np.max(np.abs(two[m][k] - want)) <= bar, (m, k)


@pytest.mark.parametrize("run", ["sgd", "adamw", "fsdp_sgd", "fsdp_adamw"])
def test_ranks_hold_bitwise_equal_params(runs, run):
    a, b = (r["acoustic"][run] for r in runs["ranks"])
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
    for k in a["stats"]:
        np.testing.assert_array_equal(a["stats"][k], b["stats"][k], err_msg=k)


def test_duration_trainer_on_two_ranks(runs):
    """2 ranks train as one process does, rank 0 writes the one
    checkpoint, and JAX's ``load_variables`` reads it."""
    import jax

    from viettts_tpu.train import checkpoint as jax_ckpt

    one, two = runs["single"]["duration"], [r["duration"] for r in runs["ranks"]]
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-5)
    assert two[0]["losses"] == two[1]["losses"]
    for k in one["params"]:
        np.testing.assert_array_equal(two[0]["params"][k], two[1]["params"][k], err_msg=k)
    ckpt_dir = runs["dir"] / "ckpt"
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["duration_latest_ckpt.pickle"]
    path = ckpt_dir / "duration_latest_ckpt.pickle"
    assert jax_ckpt.load_checkpoint(path)["step"] == 2
    variables = jax_ckpt.load_variables(path, "duration")
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(variables))


def test_gan_step_matches_single_device(runs):
    one, two = runs["single"]["gan"], [r["gan"] for r in runs["ranks"]]
    for k, want in one["metrics"].items():
        assert abs(two[0]["metrics"][k] - want) <= 1e-5 * abs(want), k
    assert _max_delta(two[0]["u"], one["u"]) < 1e-6
    assert two[0]["metrics"] == two[1]["metrics"]
    for k in one["u"]:  # the spectral u depends on the weights only
        np.testing.assert_array_equal(two[0]["u"][k], two[1]["u"][k], err_msg=k)
    for k in one["gen"]:
        np.testing.assert_array_equal(two[0]["gen"][k], two[1]["gen"][k], err_msg=k)


def _assert_half_resident(resident, whole_shapes, min_size):
    """Every split leaf's parameter (its storage too) and moments hold half
    of the whole on a rank; every other leaf all of it."""
    from viettts_tpu_torch.parallel.mesh import fsdp_shard_axis

    split = 0
    for k, (n, nbytes, mu, nu) in resident.items():
        whole = int(np.prod(whole_shapes[k]))
        axis = fsdp_shard_axis(whole_shapes[k], WORLD, min_size)
        want = whole if axis is None else whole // WORLD
        split += axis is not None
        assert (n, nbytes) == (want, 4 * want), k
        assert mu in (None, want) and nu in (None, want), k
    assert split > 0


@pytest.mark.parametrize("run", ["fsdp_sgd", "fsdp_adamw"])
def test_fsdp_keeps_half_of_each_split_leaf_resident(runs, run):
    """ZeRO-3 at rest, as JAX's ``shard_params_fsdp``: between steps each
    rank's parameters and Adam moments hold half of every leaf FSDP splits
    (``min_size=256``), the whole of every other."""
    shapes = {k: v.shape for k, v in runs["single"]["acoustic"]["sgd"]["params"].items()}
    for r in runs["ranks"]:
        _assert_half_resident(r["acoustic"][run]["resident"], shapes, 256)


def test_fsdp_duration_trainer_on_two_ranks(runs):
    """``train.fsdp`` in the duration trainer, 2 steps at LSTM width 128:
    the losses of one process (rtol 1e-5) and of the 2-rank run without
    FSDP (equal: the same sums of two ranks' gradients), ranks bitwise
    equal, and half of each split leaf resident on each rank after
    training.  Its checkpoint holds whole trees: one process restores
    (``restore_state``) the parameters of the 2-rank run without FSDP
    within 1e-6, but for at most 0.1% of a leaf's elements whose gradient
    is rounding noise (the clip's norm sums the shards in another order),
    which AdamW turns into steps of up to the learning rate (1e-4) either
    way, and the conv biases that feed a BatchNorm, whose gradient is all
    rounding noise: those within 2 x 2 steps x lr, the bar of
    ``tests/test_torch_gan_train.py``; JAX's ``restore_state`` takes the
    checkpoint as its trainer's tree."""
    import jax

    from viettts_tpu.config import DurationModelConfig as JaxDurationModelConfig
    from viettts_tpu.models import DurationModel as JaxDurationModel
    from viettts_tpu.train import common as jax_common
    from viettts_tpu.train import duration as jax_duration
    from viettts_tpu.types import DurationBatch as JaxDurationBatch
    from viettts_tpu_torch.config import DurationModelConfig
    from viettts_tpu_torch.models.duration import DurationModel
    from viettts_tpu_torch.models.layers import batch_stats
    from viettts_tpu_torch.train import duration
    from viettts_tpu_torch.train.common import init_train_state, make_optimizer

    one, dp = runs["single"]["duration_wide"], runs["ranks"][0]["duration_wide"]
    two = [r["duration_fsdp"] for r in runs["ranks"]]
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(two[0]["losses"], dp["losses"], rtol=1e-6)
    assert two[0]["losses"] == two[1]["losses"]
    shapes = {k: v.shape for k, v in one["params"].items()}
    for r in two:
        _assert_half_resident(r["resident"], shapes, 2**16)

    path = runs["dir"] / "ckpt_fsdp" / "duration_latest_ckpt.pickle"
    model = DurationModel(DurationModelConfig(lstm_dim=FSDP_LSTM_DIM))
    opt = make_optimizer(1e-4)
    template = init_train_state(dict(model.named_parameters()), batch_stats(model), opt,
                                torch.Generator().manual_seed(0))
    restored = duration.restore_state(path, opt, template)
    assert restored.step == 2 and restored.opt_state.count == 2
    zero_grad = {f"encoder.convs.{i}.bias" for i in range(3)}  # feed a BatchNorm: all rounding noise
    for k, want in dp["params"].items():
        diff = np.abs(restored.params[k].detach().numpy() - want)
        assert (k in zero_grad or np.mean(diff > 1e-6) <= 1e-3) and diff.max() <= 2 * 2 * 1e-4, k
    assert all(restored.opt_state.mu[k].shape == v.shape for k, v in restored.params.items())

    jcfg = JaxDurationModelConfig(lstm_dim=FSDP_LSTM_DIM)
    toks, lengths = np.zeros((1, 8), np.int32), np.asarray([8], np.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "prenet", "zoneout"))}
    want = jax.eval_shape(lambda: JaxDurationModel(jcfg).init(keys, JaxDurationBatch(toks, lengths, None), train=True))
    jopt = jax_common.make_optimizer(1e-4, 1.0, 1e-4)
    jstate = jax_duration.restore_state(path, jopt, None)
    assert int(jstate.step) == 2
    for got, ref in ((jstate.params, want["params"]), (jstate.batch_stats, want["batch_stats"])):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(ref)]
    assert jax.tree.structure(jstate.opt_state) == jax.tree.structure(jopt.init(jstate.params))


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]), Path(sys.argv[4]))
