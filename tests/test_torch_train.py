"""The port's duration and acoustic trainers against the JAX trainers, on
the CPU, at tiny widths (lstm 16; decoder 32, postnet 16, 8 mels; B=2,
T=12 tokens, 64 frames).

Both sides start from the same seeded numpy values (shapes from
``jax.eval_shape``), loaded into the port through the checkpoint bridge.
With every dropout rate 0, zoneout 0 and no token masking, both losses
are deterministic functions of the same inputs:

* loss within 1e-5 relative; gradients per leaf within 1e-4 of the leaf's
  largest magnitude.  A conv bias that feeds a BatchNorm in training has a
  gradient that is zero in exact arithmetic (the BatchNorm removes the
  mean); both sides give rounding noise there, held to 1e-5 of the
  largest gradient instead;
* parameters after one optimizer step within 1e-6 (the zero-gradient
  biases above within the learning rate of where they started: Adam
  scales their noise up to a full step), batch statistics within 1e-5;
* zoneout's keep path (rate 1.0: every mask set on both sides), the
  learning-rate schedule with ``steps_per_update=3``, and bf16 mixed
  precision (loss within 2e-2 relative).

Checkpoints interoperate both ways, and both entry points train 2 steps
on a synthetic corpus with ``--device cpu``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from viettts_tpu.config import AcousticModelConfig, DspConfig, DurationModelConfig
from viettts_tpu.models import AcousticModel, DurationModel
from viettts_tpu.ops.mel import LogMelSpectrogram as JaxMel
from viettts_tpu.train import acoustic as jax_acoustic
from viettts_tpu.train import checkpoint as jax_ckpt
from viettts_tpu.train import common as jax_common
from viettts_tpu.train import duration as jax_duration
from viettts_tpu.types import AcousticBatch as JaxAcousticBatch
from viettts_tpu.types import DurationBatch as JaxDurationBatch
from viettts_tpu_torch import checkpoint as ckpt
from viettts_tpu_torch.data.loader import to_device
from viettts_tpu_torch.models.acoustic import AcousticModel as TorchAcoustic
from viettts_tpu_torch.models.duration import DurationModel as TorchDuration
from viettts_tpu_torch.models.layers import batch_stats
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.train import acoustic as port_acoustic
from viettts_tpu_torch.train import common as port_common
from viettts_tpu_torch.train import duration as port_duration
from viettts_tpu_torch.types import AcousticBatch, DurationBatch

from test_torch_checkpoint import _flat
from test_torch_pipeline import _seeded, port_config

REPO = Path(__file__).resolve().parents[1]
B, T, FRAMES, VOCAB = 2, 12, 64, 40
LR = 1e-4
DSP = DspConfig(n_fft=256, hop_length=64, win_length=256, mel_dim=8)
DURATION = DurationModelConfig(vocab_size=VOCAB, lstm_dim=16, dropout_rate=0.0)
ACOUSTIC = AcousticModelConfig(
    vocab_size=VOCAB, encoder_dim=16, decoder_dim=32, prenet_dim=16, postnet_dim=16, mel_dim=8,
    encoder_dropout_rate=0.0, prenet_dropout_rate=0.0, postnet_dropout_rate=0.0,
    prenet_dropout_at_inference=False, zoneout_rate=0.0,
)
# biases whose gradient is zero in exact arithmetic: a conv feeding a
# BatchNorm in training
ZERO_GRAD = ("conv_0/bias", "conv_1/bias", "conv_2/bias") + tuple(f"postnet_conv_{i}/bias" for i in range(4))


def _batches(seed, n=1):
    """``n`` seeded duration and acoustic batches (numpy): ragged lengths,
    word-end tokens inside the rows, a zero-padded waveform tail."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lengths = np.asarray([T, 7], np.int32)
        toks = rng.randint(4, VOCAB, (B, T)).astype(np.int32)
        toks[:, 3] = 3  # a word end
        durs = rng.uniform(0.02, 0.08, (B, T)).astype(np.float32)
        for i, n_tok in enumerate(lengths):
            toks[i, n_tok:] = 0
            durs[i, n_tok:] = 0.0
        wavs = (rng.randn(B, FRAMES * DSP.hop_length) * 3000).astype(np.int16)
        wav_lengths = np.asarray([FRAMES * DSP.hop_length, 2900], np.int32)
        wavs[1, 2900:] = 0
        out.append((DurationBatch(toks, lengths, durs), AcousticBatch(toks, lengths, durs, wavs, wav_lengths, None)))
    return out


def _jax_batch(b):
    if isinstance(b, DurationBatch):
        return JaxDurationBatch(*(jnp.asarray(a) for a in b))
    return JaxAcousticBatch(*(None if a is None else jnp.asarray(a) for a in b))


def _stack(batches):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[_jax_batch(b) for b in batches])


def _variables(kind, cfg, seed=0):
    rng = np.random.RandomState(seed)
    toks, lengths = jnp.zeros((1, 8), jnp.int32), jnp.asarray([8], jnp.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "prenet", "zoneout"))}
    if kind == "duration":
        model = DurationModel(cfg)
        shapes = jax.eval_shape(lambda: model.init(keys, JaxDurationBatch(toks, lengths, None), train=True))
    else:
        model = AcousticModel(cfg)
        batch = JaxAcousticBatch(toks, lengths, jnp.ones((1, 8)), None, None, jnp.zeros((1, 16, cfg.mel_dim)))
        shapes = jax.eval_shape(lambda: model.init(keys, batch, train=True))
    variables = _seeded({"params": shapes["params"], "batch_stats": shapes["batch_stats"]}, rng)
    return model, variables


class Pair:
    """One model on both sides, from the same values, with each side's
    loss functions."""

    def __init__(self, kind, cfg, mixed_precision=False, seed=0):
        self.kind = kind
        self.jax_model, self.variables = _variables(kind, cfg, seed)
        pcfg = port_config(cfg)
        if kind == "duration":
            self.port_model = TorchDuration(pcfg)
            ckpt.load_duration(self.port_model, self.variables)
            self.jax_loss = jax_duration.make_loss_fn(self.jax_model, 0.0, train=True)
            self.port_loss = port_duration.make_loss_fn(self.port_model, 0.0, train=True)
        else:
            self.port_model = TorchAcoustic(pcfg)
            ckpt.load_acoustic(self.port_model, self.variables)
            self.jax_loss = jax_acoustic.make_loss_fn(self.jax_model, JaxMel(DSP), DSP.hop_length, train=True)
            self.port_loss = port_acoustic.make_loss_fn(
                self.port_model, LogMelSpectrogram(port_config(DSP)), DSP.hop_length, train=True
            )
        if mixed_precision:
            self.jax_loss = jax_common.mixed_precision_loss(self.jax_loss)
            self.port_loss = port_common.mixed_precision_loss(self.port_loss)

    def batch(self, pair):
        return pair[0] if self.kind == "duration" else pair[1]

    def jax_state(self, optimizer):
        v = jax.tree.map(jnp.asarray, self.variables)
        return jax_common.init_train_state(v["params"], v["batch_stats"], optimizer, jax.random.PRNGKey(0))

    def port_state(self, optimizer):
        m = self.port_model
        return port_common.init_train_state(
            dict(m.named_parameters()), batch_stats(m), optimizer, torch.Generator().manual_seed(0)
        )


def _rel(got, want):
    got, want = float(torch.as_tensor(got).detach()), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


def _assert_grads_close(port_grads, jax_grads):
    got, want = _flat(ckpt.jax_tree(port_grads)["params"]), _flat(jax_grads)
    assert sorted(got) == sorted(want)
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if k.endswith(ZERO_GRAD):
            assert np.abs(got[k]).max() <= 1e-5 * scale and np.abs(w).max() <= 1e-5 * scale, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def _check_loss_and_grads(pair: Pair, batch):
    jb = _jax_batch(batch)
    (want, _), jgrads = jax.jit(jax.value_and_grad(pair.jax_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, pair.variables["params"]),
        jax.tree.map(jnp.asarray, pair.variables["batch_stats"]),
        jax.random.PRNGKey(0),
        jb,
    )
    m = pair.port_model
    params = dict(m.named_parameters())
    loss, _ = pair.port_loss(params, batch_stats(m), torch.Generator().manual_seed(0), to_device(batch, torch.device("cpu")))
    grads = torch.autograd.grad(loss, list(params.values()))
    assert _rel(loss, want) <= 1e-5, (float(loss), float(want))
    _assert_grads_close(dict(zip(params, grads)), jgrads)


@pytest.mark.parametrize("kind", ["duration", "acoustic"])
def test_loss_and_gradients_match_jax(kind):
    pair = Pair(kind, DURATION if kind == "duration" else ACOUSTIC)
    _check_loss_and_grads(pair, pair.batch(_batches(1)[0]))


def test_zoneout_keep_path_matches_jax():
    """zoneout_rate=1.0: every keep-previous mask is set on both sides (a
    uniform draw is always below 1), so the state never leaves zero and
    each frame's output is one step from the zero state."""
    pair = Pair("acoustic", dataclasses.replace(ACOUSTIC, zoneout_rate=1.0))
    _check_loss_and_grads(pair, pair.batch(_batches(2)[0]))


def _compare_states(port_state, jax_state, before=None, steps=1):
    """Parameters within 1e-6 and statistics within 1e-5 after ``steps``
    optimizer steps from ``before`` (a variable tree).  Adam turns the
    rounding noise of a zero-gradient leaf (``ZERO_GRAD``) into steps of
    up to the learning rate, of either sign: there each side must have
    moved by at most ``steps * LR``.  Those biases then part by up to
    2 LR a step, and a BatchNorm's batch mean carries its conv's bias
    into the running mean at weight 0.1: a running mean may part by
    0.1 * 2 LR * (0 + 1 + ... + steps - 1) more."""
    got = _flat({**ckpt.jax_tree(port_state.params), **ckpt.jax_tree(port_state.batch_stats)})
    want = _flat({"params": jax_state.params, "batch_stats": jax_state.batch_stats})
    assert sorted(got) == sorted(want)
    start = None if before is None else _flat(before)
    for k, w in want.items():
        w = np.asarray(w)
        if start is not None and k.endswith(ZERO_GRAD):
            for side in (got[k], w):
                assert np.abs(side - start[k]).max() <= steps * LR * 1.01, k
        elif "batch_stats" in k:
            drift = 0.1 * LR * steps * (steps - 1) if k.endswith("/mean") else 0.0
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5 + drift, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["duration", "acoustic"])
def test_update_step_matches_jax(kind):
    pair = Pair(kind, DURATION if kind == "duration" else ACOUSTIC)
    batch = pair.batch(_batches(3)[0])
    jopt = jax_common.make_optimizer(LR, 1.0, 1e-4)
    jstate, jloss = jax_common.make_update_fn(pair.jax_loss, jopt)(pair.jax_state(jopt), _stack([batch]))
    popt = port_common.make_optimizer(LR, 1.0, 1e-4)
    pstate, ploss = port_common.make_update_fn(pair.port_loss, popt)(
        pair.port_state(popt), [to_device(batch, torch.device("cpu"))]
    )
    assert _rel(ploss, jloss) <= 1e-5
    assert pstate.step == int(jstate.step) == 1
    _compare_states(pstate, jstate, pair.variables)


def test_steps_per_update_with_schedule_matches_jax():
    """Three optimizer steps in one update call under the staircase
    schedule, as the acoustic trainer runs with ``steps_per_update > 1``:
    mean loss, parameters, and the optimizer's counts."""
    pair = Pair("acoustic", ACOUSTIC)
    batches = [pair.batch(b) for b in _batches(4, n=3)]
    jopt = jax_common.make_optimizer(optax.exponential_decay(LR, 50_000, 0.5, staircase=True), 1.0, 1e-4)
    jstate, jloss = jax_common.make_update_fn(pair.jax_loss, jopt)(pair.jax_state(jopt), _stack(batches))
    popt = port_common.make_optimizer(port_common.exponential_decay(LR, 50_000, 0.5, staircase=True), 1.0, 1e-4)
    pstate, ploss = port_common.make_update_fn(pair.port_loss, popt)(
        pair.port_state(popt), to_device(batches, torch.device("cpu"))
    )
    assert _rel(ploss, jloss) <= 1e-5
    _compare_states(pstate, jstate, pair.variables, steps=3)
    _, (adam, _, sched) = jstate.opt_state
    assert pstate.opt_state.count == int(adam.count) == 3
    assert pstate.opt_state.schedule_count == int(sched.count) == 3


@pytest.mark.parametrize("count", [0, 1, 49_999, 50_000, 125_000])
def test_exponential_decay_matches_optax(count):
    want = optax.exponential_decay(3e-4, 50_000, 0.5, staircase=True)(count)
    assert port_common.exponential_decay(3e-4, 50_000, 0.5, staircase=True)(count) == float(want)


@pytest.mark.parametrize("scale,max_norm", [(0.1, 1.0), (0.3, 1.0), (7.0, 1.0), (5e-6, 1e-5)])
def test_clip_matches_optax_without_eps(scale, max_norm):
    """Global-norm clipping scales by max_norm / g_norm only at or above
    max_norm, with no 1e-6 in the norm (at max_norm 1e-5 an eps would move
    the scale by 5%): one AdamW step on a lone leaf, its first moment and
    the parameter after it."""
    g = (np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5) * scale  # norm 4.18 x scale
    p = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    opt = jax_common.make_optimizer(1e-2, max_norm, 1e-4)
    updates, state = opt.update({"w": jnp.asarray(g)}, opt.init({"w": jnp.asarray(p)}), {"w": jnp.asarray(p)})
    popt = port_common.make_optimizer(1e-2, max_norm, 1e-4)
    params = {"w": torch.from_numpy(p.copy())}
    pstate = popt.update({"w": torch.from_numpy(g)}, popt.init(params), params)
    np.testing.assert_allclose(pstate.mu["w"].numpy(), np.asarray(state[1][0].mu["w"]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(params["w"].numpy(), p + np.asarray(updates["w"]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("kind", ["duration", "acoustic"])
def test_mixed_precision_loss_matches_jax(kind):
    pair = Pair(kind, DURATION if kind == "duration" else ACOUSTIC, mixed_precision=True)
    batch = pair.batch(_batches(5)[0])
    want, _ = pair.jax_loss(
        jax.tree.map(jnp.asarray, pair.variables["params"]),
        jax.tree.map(jnp.asarray, pair.variables["batch_stats"]),
        jax.random.PRNGKey(0),
        _jax_batch(batch),
    )
    m = pair.port_model
    got, stats = pair.port_loss(
        dict(m.named_parameters()), batch_stats(m), torch.Generator().manual_seed(0), to_device(batch, torch.device("cpu"))
    )
    assert got.dtype == torch.float32 and all(s.dtype == torch.float32 for s in stats.values())
    assert _rel(got, want) <= 2e-2, (float(got), float(want))


# ---------------------------------------------------------------------------
# Checkpoints, both directions.
# ---------------------------------------------------------------------------


def _port_step(pair, batch):
    popt = port_common.make_optimizer(LR, 1.0, 1e-4)
    state, _ = port_common.make_update_fn(pair.port_loss, popt)(pair.port_state(popt), [to_device(batch, torch.device("cpu"))])
    return state


@pytest.mark.parametrize("kind", ["duration", "acoustic"])
def test_port_checkpoint_loads_and_resumes_in_jax(kind, tmp_path):
    """A port-written training checkpoint: JAX's ``load_variables`` reads
    it and its model gives the port's output; JAX's ``restore_state``
    takes it, with the port's moments, and JAX trains one more step."""
    pair = Pair(kind, DURATION if kind == "duration" else ACOUSTIC)
    batch = pair.batch(_batches(6)[0])
    state = _port_step(pair, batch)
    path = tmp_path / f"{kind}_latest_ckpt.pickle"
    port_duration.save_native_ckpt(path, state)

    variables = jax_ckpt.load_variables(path, kind)
    jb = _jax_batch(batch)
    m = pair.port_model
    with torch.no_grad():
        if kind == "duration":
            want = np.asarray(pair.jax_model.apply(variables, jb, train=False))
            got = m(to_device(batch, torch.device("cpu")), train=False).numpy()
        else:
            tokens = torch.from_numpy(batch.phonemes).long()
            frames = torch.from_numpy(batch.durations * DSP.sample_rate / DSP.hop_length)
            lengths = torch.from_numpy(batch.lengths).long()
            want = np.asarray(pair.jax_model.apply(
                variables, jb.phonemes, jb.durations * DSP.sample_rate / DSP.hop_length, 16, jb.lengths,
                method=AcousticModel.inference,
            ))
            m.merge_decoder_weights()  # the decode kernel's weights, from the trained ones
            got = m.inference(tokens, frames, 16, lengths).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    jopt = jax_common.make_optimizer(LR, 1.0, 1e-4)
    template = pair.jax_state(jopt)
    restored = jax_duration.restore_state(path, jopt, template)
    assert int(restored.step) == 1
    _, (adam, _, _) = restored.opt_state
    np.testing.assert_array_equal(_flat(adam.mu)["/encoder/lstm_fwd/w_h"],
                                  state.opt_state.mu["encoder.lstm_fwd.w_h"].numpy())
    after, loss = jax_common.make_update_fn(pair.jax_loss, jopt)(restored, _stack([batch]))
    assert int(after.step) == 2 and np.isfinite(float(loss))


def test_port_resumes_jax_checkpoint(tmp_path):
    """A JAX-written training checkpoint after one step: the port restores
    the same parameters, statistics, moments and counts."""
    pair = Pair("acoustic", ACOUSTIC)
    batch = pair.batch(_batches(7)[0])
    jopt = jax_common.make_optimizer(LR, 1.0, 1e-4)
    jstate, _ = jax_common.make_update_fn(pair.jax_loss, jopt)(pair.jax_state(jopt), _stack([batch]))
    path = tmp_path / "acoustic_latest_ckpt.pickle"
    jax_duration.save_native_ckpt(path, jstate)

    popt = port_common.make_optimizer(LR, 1.0, 1e-4)
    restored = port_duration.restore_state(path, popt, pair.port_state(popt))
    assert restored.step == 1 and restored.opt_state.count == 1 and restored.opt_state.schedule_count is None
    _compare_states(restored, jstate)
    _, (adam, _, _) = jstate.opt_state
    for tree, got in ((adam.mu, restored.opt_state.mu), (adam.nu, restored.opt_state.nu)):
        want = _flat(tree)
        mine = _flat(ckpt.jax_tree(got)["params"])
        for k in want:
            np.testing.assert_array_equal(mine[k], np.asarray(want[k]), err_msg=k)


def test_orbax_and_many_devices_are_refused():
    """Orbax is refused; more than one device or FSDP is refused without
    a process group (one process per device), with the torchrun hint."""
    from viettts_tpu_torch.config import TrainConfig
    from viettts_tpu_torch.parallel.mesh import check_data_parallel
    from viettts_tpu_torch.train.checkpoint import check_format

    with pytest.raises(ValueError, match="Orbax"):
        check_format("orbax")
    for bad in (dict(num_devices=8), dict(fsdp=True)):
        tcfg = TrainConfig(**bad)
        with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
            check_data_parallel(tcfg.num_devices, tcfg.batch_size, tcfg.fsdp)
    assert check_data_parallel(-1, 64) is False and check_data_parallel(1, 64) is False
    with pytest.raises(ValueError, match="num_devices=0"):
        TrainConfig(num_devices=0)


def test_init_params_match_flax_in_distribution():
    """``init_params`` draws each leaf from the JAX model's initialiser:
    the spread of every matrix within 15% of flax's own ``init`` at
    default-sized leaves; vectors start at the same constants."""
    cfg = dataclasses.replace(ACOUSTIC, encoder_dim=64, decoder_dim=64, prenet_dim=64, postnet_dim=64, mel_dim=80)
    key = jax.random.PRNGKey(0)
    toks, lengths = jnp.zeros((1, 8), jnp.int32), jnp.asarray([8], jnp.int32)
    batch = JaxAcousticBatch(toks, lengths, jnp.ones((1, 8)), None, None, jnp.zeros((1, 16, 80)))
    rngs = {"params": key, "dropout": key, "prenet": key, "zoneout": key}
    want = _flat(jax.jit(lambda: AcousticModel(cfg).init(rngs, batch, train=True))())
    port = TorchAcoustic(port_config(cfg))
    port.init_params(torch.Generator().manual_seed(0))
    got = _flat(ckpt.jax_tree(port.state_dict()))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        if w.ndim == 1:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert abs(got[k].std() / w.std() - 1) < 0.15, (k, got[k].std(), w.std())
            if "embed" not in k:  # truncated at 2 sigma, sigma = std / 0.88
                assert np.abs(got[k]).max() <= 1.05 * 2.0 * got[k].std() / 0.8796, k


# ---------------------------------------------------------------------------
# The entry points.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from validate_e2e_training import build_corpus
    finally:
        sys.path.remove(str(REPO / "scripts"))
    d = tmp_path_factory.mktemp("corpus")
    build_corpus(d, n_utts=24, seed=0)
    return d


TINY = [
    "--set", "train.batch_size=4", "--set", "train.val_interval=1", "--set", "train.ckpt_interval=1",
    "--set", "data.max_wave_len=16384", "--set", "data.max_phoneme_seq_len=64",
    "--set", "duration.lstm_dim=16", "--set", "acoustic.encoder_dim=16", "--set", "acoustic.decoder_dim=32",
    "--set", "acoustic.prenet_dim=16", "--set", "acoustic.postnet_dim=16",
]


@pytest.mark.parametrize("kind", ["duration", "acoustic"])
def test_entry_point_trains_on_cpu_and_resumes(kind, corpus, tmp_path, capsys):
    """``main([... "--device", "cpu"])`` trains 2 steps and writes a
    checkpoint that JAX reads; a second run with 3 steps resumes at 2."""
    main = port_duration.main if kind == "duration" else port_acoustic.main
    args = ["--data-dir", str(corpus), "--ckpt-dir", str(tmp_path), "--device", "cpu", *TINY]
    main(args + ["--set", "train.num_training_steps=2"])
    out = capsys.readouterr().out
    assert "step       2 | train" in out
    path = tmp_path / f"{kind}_latest_ckpt.pickle"
    variables = jax_ckpt.load_variables(path, kind)
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(variables))
    main(args + ["--set", "train.num_training_steps=3"])
    assert f"Resuming from {path} at step 2" in capsys.readouterr().out
    assert jax_ckpt.load_checkpoint(path)["step"] == 3


def test_entry_point_without_cuda_fails(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_duration.main(["--data-dir", str(corpus), "--ckpt-dir", str(tmp_path), *TINY])
