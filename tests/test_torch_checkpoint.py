"""Checkpoint reading and the weight bridge of the PyTorch port.

* The numpy haiku converters against ``viettts_tpu.train.checkpoint``'s.
* Native pickles written by the JAX ``save_checkpoint`` load through the
  port's unpickler, which maps ``viettts_tpu.ops.rnn.LSTMParams`` to its
  own class instead of importing jax.
* The port's modules hold exactly the JAX models' parameters.
* With ``jax``, ``flax`` and ``optax`` made unimportable, the port imports
  and synthesizes on the CPU in a subprocess.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from viettts_tpu.config import AcousticModelConfig, DurationModelConfig, HifiGanConfig
from viettts_tpu.models import AcousticModel, DurationModel, Generator
from viettts_tpu.train import checkpoint as jax_ckpt
from viettts_tpu.types import AcousticBatch, DurationBatch
from viettts_tpu_torch import checkpoint as ckpt
from viettts_tpu_torch.models.acoustic import AcousticModel as TorchAcoustic
from viettts_tpu_torch.models.duration import DurationModel as TorchDuration
from viettts_tpu_torch.models.hifigan import Generator as TorchGenerator

from test_torch_pipeline import _cfg, _write_checkpoints

REPO = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of dicts and NamedTuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _Rand:
    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def __call__(self, *shape):
        return self.rng.randn(*shape).astype(np.float32)

    def linear(self, i, o, bias=True):
        return {"w": self(i, o), "b": self(o)} if bias else {"w": self(i, o)}

    def conv(self, k, i, o):
        return {"w": self(k, i, o), "b": self(o)}


def _haiku_bn(r, params, state, name, C):
    params[name] = {"scale": r(1, 1, C), "offset": r(1, 1, C)}
    state[f"{name}/~/mean_ema"] = {"average": r(1, 1, C)}
    state[f"{name}/~/var_ema"] = {"average": r(1, 1, C)}


def _haiku_encoder(r, params, state, scope, V, C):
    params[f"{scope}/~/embed"] = {"embeddings": r(V, C)}
    for i, sfx in enumerate(("", "_1", "_2")):
        params[f"{scope}/~/conv1_d{sfx}"] = r.conv(3, C, C)
        _haiku_bn(r, params, state, f"{scope}/~/batch_norm{sfx}", C)
    params[f"{scope}/~/lstm/linear"] = r.linear(2 * C, 4 * C)
    params[f"{scope}/~/lstm_1/linear"] = r.linear(2 * C, 4 * C)


def _haiku_tree(kind, seed=0):
    r, params, state = _Rand(seed), {}, {}
    V, C, H, P, D = 11, 4, 6, 3, 5
    if kind == "duration":
        root = "duration_model"
        _haiku_encoder(r, params, state, f"{root}/~/token_encoder", V, C)
        params[f"{root}/~/linear"] = r.linear(2 * C, C)
        params[f"{root}/~/linear_1"] = r.linear(C, 1)
        return params, state
    if kind == "acoustic":
        root = "acoustic_model"
        _haiku_encoder(r, params, state, f"{root}/~/token_encoder", V, C)
        params[f"{root}/~/lstm/linear"] = r.linear(2 * C + P + H, 4 * H)
        params[f"{root}/~/lstm_1/linear"] = r.linear(2 * C + P + 2 * H, 4 * H)
        params[f"{root}/~/linear"] = r.linear(2 * H, D)
        params[f"{root}/~/linear_1"] = r.linear(D, P, bias=False)
        params[f"{root}/~/linear_2"] = r.linear(P, P, bias=False)
        for i, sfx in enumerate(("", "_1", "_2", "_3", "_4")):
            params[f"{root}/~/conv1_d{sfx}"] = r.conv(5, D if i in (0, 4) else 7, 7)
            if i < 4:
                _haiku_bn(r, params, state, f"{root}/~/batch_norm{sfx}", 7)
        return params, state
    flat = {"generator/~/conv1_d": r.conv(7, D, 8), "generator/~/conv1_d_1": r.conv(7, 1, 1)}
    for i in range(4):
        flat[f"generator/~/ups_{i}"] = r.conv(4, 2, 3)  # haiku (W, O, I)
    for b in range(12):
        for j in range(3):
            for name in ("convs1", "convs2"):
                flat[f"generator/~/res_block1_{b}/~/{name}_{j}"] = r.conv(3, 2, 2)
    return flat, None


@pytest.mark.parametrize("kind", ["duration", "acoustic", "hifigan"])
def test_haiku_converters_match_jax(kind):
    params, state = _haiku_tree(kind)
    if kind == "duration":
        got, want = ckpt.convert_haiku_duration(params, state), jax_ckpt.convert_haiku_duration(params, state)
    elif kind == "acoustic":
        got, want = ckpt.convert_haiku_acoustic(params, state), jax_ckpt.convert_haiku_acoustic(params, state)
    else:
        got, want = ckpt.convert_haiku_hifigan(params), jax_ckpt.convert_haiku_hifigan(params)
    _assert_same_tree(got, want)


@pytest.mark.parametrize("kind", ["duration", "acoustic", "hifigan"])
def test_reference_pickles_load_through_port(kind, tmp_path):
    """A reference-format (haiku) file reads the same through both loaders."""
    params, state = _haiku_tree(kind, seed=1)
    path = tmp_path / f"{kind}.pickle"
    with open(path, "wb") as f:
        pickle.dump(params if kind == "hifigan" else {"params": params, "aux": state}, f)
    _assert_same_tree(ckpt.load_variables(path, kind), jax_ckpt.load_variables(path, kind))


@pytest.fixture(scope="module")
def native_dir(tmp_path_factory):
    return _write_checkpoints(_cfg(), tmp_path_factory.mktemp("native_ckpts"))


@pytest.mark.parametrize("kind", ["duration", "acoustic", "hifigan"])
def test_native_pickles_load_through_port(native_dir, kind):
    path = native_dir / f"{kind}_latest_ckpt.pickle"
    got = ckpt.load_variables(path, kind)
    _assert_same_tree(got, jax_ckpt.load_variables(path, kind))
    if kind == "acoustic":  # LSTMs come back as the port's numpy NamedTuple
        assert type(got["params"]["decoder_lstm1"]) is ckpt.LSTMParams


def _trainer_checkpoint(native_dir, path):
    """A duration checkpoint as the trainers write it: variables plus the
    optax state (NamedTuples whose pickles name ``optax...``)."""
    from viettts_tpu.train.common import make_optimizer

    variables = jax_ckpt.load_variables(native_dir / "duration_latest_ckpt.pickle", "duration")
    opt_state = make_optimizer(1e-3).init(jax.tree.map(jnp.asarray, variables["params"]))
    jax_ckpt.save_checkpoint(
        path, {"format": ckpt.NATIVE_FORMAT, "step": 3, "variables": variables, "opt_state": opt_state}
    )
    return variables


def test_trainer_checkpoint_with_optimizer_state_loads(native_dir, tmp_path):
    path = tmp_path / "duration_latest_ckpt.pickle"
    variables = _trainer_checkpoint(native_dir, path)
    _assert_same_tree(ckpt.load_variables(path, "duration"), variables)


def test_unpickler_refuses_jax_classes(tmp_path):
    path = tmp_path / "jax_array.pickle"
    with open(path, "wb") as f:
        pickle.dump({"format": ckpt.NATIVE_FORMAT, "variables": {"w": jnp.ones(3)}}, f)
    with pytest.raises(pickle.UnpicklingError, match="cannot read without jax"):
        ckpt.load_variables(path, "duration")


def _n_params(variables):
    return sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(variables["params"]))


def _n_torch(module):
    return sum(p.numel() for p in module.parameters())


@pytest.mark.parametrize("kind", ["duration", "acoustic", "hifigan1", "hifigan2"])
def test_parameter_counts_equal(kind):
    toks, lengths = jnp.zeros((1, 8), jnp.int32), jnp.asarray([8], jnp.int32)
    key = jax.random.PRNGKey(0)
    if kind == "duration":
        cfg = DurationModelConfig(lstm_dim=16)
        variables = jax.eval_shape(
            lambda: DurationModel(cfg).init(key, DurationBatch(toks, lengths, None), train=False)
        )
        port = TorchDuration(cfg)
    elif kind == "acoustic":
        cfg = AcousticModelConfig(encoder_dim=16, decoder_dim=24, prenet_dim=8, postnet_dim=12)
        batch = AcousticBatch(toks, lengths, jnp.ones((1, 8)), None, None, jnp.zeros((1, 16, 80)))
        rngs = {"params": key, "dropout": key, "prenet": key, "zoneout": key}
        variables = jax.eval_shape(lambda: AcousticModel(cfg).init(rngs, batch, train=True))
        port = TorchAcoustic(cfg)
    else:
        cfg = HifiGanConfig(resblock=kind[-1], upsample_initial_channel=32)
        variables = jax.eval_shape(lambda: Generator(cfg).init(key, jnp.zeros((1, 4, 80))))
        port = TorchGenerator(cfg)
    assert _n_torch(port) == _n_params(variables)


_NO_JAX_SCRIPT = r"""
import importlib, importlib.abc, json, pickle, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import viettts_tpu_torch
for m in pkgutil.walk_packages(viettts_tpu_torch.__path__, "viettts_tpu_torch."):
    importlib.import_module(m.name)
from viettts_tpu_torch.infer.pipeline import Synthesizer

from viettts_tpu_torch.checkpoint import load_variables

with open(sys.argv[1], "rb") as f:
    cfg = pickle.load(f)
trainer_vars = load_variables(sys.argv[2], "duration")  # holds optax state
res = Synthesizer(cfg, device="cpu").synthesize("xin chào các bạn")
print(json.dumps({
    "jax_loaded": any(n.split(".")[0] in ("jax", "flax", "optax") for n in sys.modules),
    "samples": len(res.wave), "frames": res.mel.shape[0],
    "finite": bool(np.isfinite(res.wave).all()),
    "trainer_ckpt_keys": sorted(trainer_vars),
}))
"""


def test_port_runs_with_jax_unimportable(native_dir, tmp_path):
    cfg_path, trainer_path = tmp_path / "cfg.pickle", tmp_path / "trainer.pickle"
    with open(cfg_path, "wb") as f:
        pickle.dump(_cfg(native_dir), f)
    _trainer_checkpoint(native_dir, trainer_path)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, str(cfg_path), str(trainer_path)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_loaded"] is False
    assert out["finite"] and out["frames"] > 0 and out["samples"] == out["frames"] * 256
    assert out["trainer_ckpt_keys"] == ["batch_stats", "params"]
