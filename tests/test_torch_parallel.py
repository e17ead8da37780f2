"""The port's multi-device layer (``viettts_tpu_torch/parallel/mesh.py``)
against the JAX package's ``viettts_tpu/parallel/mesh.py``.

* ``fsdp_shard_axis`` picks the axis of JAX's ``fsdp_sharding_for`` on
  the 8-device CPU mesh, for ``tests/test_fsdp.py``'s shapes and more.
* On 2 ranks (``gloo``, a ``file://`` store; the file runs itself as the
  two ranks, once, in a module fixture): ``shard_batch``'s row slices,
  its "not divisible" error and its replicate opt-in (as
  ``tests/test_dp_equivalence.py`` checks JAX's); ``BatchNorm`` in
  training inside ``data_parallel()`` gives the output, ``new_stats`` and
  the input gradient of one process on the concatenated batch within
  1e-6, the parameter gradients within 1e-6 of their largest (at least
  1e-6); ``rand_rows`` draws what one process draws; the
  FSDP gather and reduce-scatter and the gradient all-reduce.
* Without a group: ``world()`` is (0, 1), ``shard_batch`` passes the whole
  batch, ``data_parallel()`` and ``initialize_distributed`` refuse.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 120
X_SHAPE = (6, 5, 7)  # a global [B, C, T] batch for BatchNorm


class Pair(NamedTuple):
    a: object
    b: object


def _bn_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(X_SHAPE).astype(np.float32) * 2 + 0.5
    w = rng.standard_normal(X_SHAPE).astype(np.float32)
    return x, w


def batch_norm(x: np.ndarray, w: np.ndarray, dp: bool) -> dict:
    """One training forward of ``BatchNorm`` and the gradients of
    ``sum(y * w)``; with ``dp`` each rank holds its rows."""
    from viettts_tpu_torch.models.layers import BatchNorm
    from viettts_tpu_torch.parallel import mesh

    bn = BatchNorm(X_SHAPE[1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, X_SHAPE[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, X_SHAPE[1]))
        bn.running_mean.fill_(0.1)
        bn.running_var.fill_(0.9)
    if dp:
        x, w = mesh.shard_batch((x, w))
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
    with mesh.data_parallel() if dp else contextlib.nullcontext():
        y = bn(xt, train=True)
        loss = torch.sum(y * torch.from_numpy(np.ascontiguousarray(w)))
        gx, gw, gb = torch.autograd.grad(loss, [xt, bn.weight, bn.bias])
    if dp:
        gw, gb = mesh.all_reduce_grads([gw, gb])
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "gw": gw.numpy(), "gb": gb.numpy(),
            "mean": bn.new_stats[0].numpy(), "var": bn.new_stats[1].numpy()}


def worker(store: str, rank: int, out_dir: Path) -> None:
    import torch.distributed as dist

    from viettts_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.initialize_distributed(store, WORLD, rank, device="cpu")
    out = {"world": mesh.world()}
    arr = np.arange(24).reshape(6, 4)
    ten = torch.arange(12.0).reshape(2, 6)
    rows = mesh.shard_batch(Pair(arr, {"t": torch.arange(6), "s": np.float32(3.0), "none": None}))
    out["rows"] = {"type": type(rows).__name__, "a": rows.a, "b": rows.b}
    out["rows_axis1"] = mesh.shard_batch(ten, batch_axis=1).numpy()
    try:
        mesh.shard_batch({"x": np.zeros((5, 4))})
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    out["replicated"] = mesh.shard_batch({"x": np.zeros((5, 4))}, on_indivisible="replicate")["x"].shape
    out["bn"] = batch_norm(*_bn_inputs(), dp=True)
    with mesh.data_parallel():
        out["rand"] = mesh.rand_rows((3, 4, 2), torch.Generator().manual_seed(3), "cpu", batch_axis=1).numpy()
    full = torch.arange(24.0).reshape(3, 4, 2) * (rank + 1)
    out["scatter"] = mesh.reduce_scatter_shard(full, 1).numpy()
    out["gather"] = mesh.all_gather_shard(mesh.shard_of(full, 1), 1).numpy()
    out["mean"] = [g.numpy() for g in mesh.all_reduce_grads(
        [torch.full((2, 3), float(rank)), torch.full((4,), 2.0 * rank, dtype=torch.float64)], "mean")]
    out["value"] = float(mesh.all_reduce_value(torch.tensor(1.0 + rank)))
    dist.destroy_process_group()
    with open(out_dir / f"rank{rank}.pickle", "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, f"file://{tmp / 'store'}", str(r), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
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
    results = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pickle", "rb") as f:
            results.append(pickle.load(f))
    return results


FSDP_SHAPES = [(512, 1024), (17,), (257, 33 * 9), (1024, 512), (256, 256), (8, 8192), (3, 40000),
               (40000, 3), (2, 2, 16384), (65536,), (65535,), (96, 80, 5), (1024, 1024, 3), ()]


@pytest.mark.parametrize("shape", FSDP_SHAPES, ids=str)
def test_fsdp_shard_axis_matches_jax(shape):
    """The JAX package's rule on its 8-device mesh: the sharded axis of
    ``fsdp_sharding_for``'s spec, or None for a replicated leaf."""
    import jax
    import jax.numpy as jnp

    from viettts_tpu.parallel.mesh import fsdp_sharding_for, make_mesh
    from viettts_tpu_torch.parallel.mesh import fsdp_shard_axis

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    spec = tuple(fsdp_sharding_for(jnp.zeros(shape), make_mesh(8)).spec)
    want = spec.index("data") if "data" in spec else None
    assert fsdp_shard_axis(shape, 8) == want
    for min_size in (1, 256):
        spec = tuple(fsdp_sharding_for(jnp.zeros(shape), make_mesh(8), min_size).spec)
        assert fsdp_shard_axis(shape, 8, min_size) == (spec.index("data") if "data" in spec else None)


def test_shard_batch_takes_each_ranks_rows(ranks):
    for r, out in enumerate(ranks):
        assert out["world"] == (r, WORLD)
        rows = out["rows"]
        assert rows["type"] == "Pair"
        np.testing.assert_array_equal(rows["a"], np.arange(24).reshape(6, 4)[3 * r:3 * r + 3])
        np.testing.assert_array_equal(rows["b"]["t"].numpy(), np.arange(6)[3 * r:3 * r + 3])
        assert rows["b"]["s"] == np.float32(3.0) and rows["b"]["none"] is None
        np.testing.assert_array_equal(out["rows_axis1"], np.arange(12.0).reshape(2, 6)[:, 3 * r:3 * r + 3])


def test_shard_batch_rejects_indivisible_batch(ranks):
    for out in ranks:
        assert "not divisible" in out["indivisible"] and "world size 2" in out["indivisible"]
        assert out["replicated"] == (5, 4)


def test_batch_norm_on_two_ranks_matches_one(ranks):
    one = batch_norm(*_bn_inputs(), dp=False)
    for r, out in enumerate(ranks):
        got = out["bn"]
        rows = slice(3 * r, 3 * r + 3)
        np.testing.assert_allclose(got["y"], one["y"][rows], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["gx"], one["gx"][rows], atol=1e-6, rtol=0)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], one[k], atol=1e-6, rtol=0, err_msg=k)
        for k in ("gw", "gb"):  # sums over 42 positions of O(1) terms: 1e-6 of the largest, at least
            np.testing.assert_allclose(got[k], one[k], atol=1e-6 * max(1.0, np.abs(one[k]).max()), rtol=0,
                                       err_msg=k)
    for k in ("mean", "var", "gw", "gb"):
        np.testing.assert_array_equal(ranks[0]["bn"][k], ranks[1]["bn"][k])


def test_rand_rows_draws_the_global_batch(ranks):
    want = torch.rand((3, 8, 2), generator=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(np.concatenate([out["rand"] for out in ranks], axis=1), want)


def test_collectives(ranks):
    full = np.arange(24.0).reshape(3, 4, 2)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["scatter"], 3 * full[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["gather"], np.concatenate([full[:, :2], 2 * full[:, 2:]], axis=1))
        np.testing.assert_array_equal(out["mean"][0], np.full((2, 3), 0.5, np.float32))
        assert out["mean"][1].dtype == np.float64
        np.testing.assert_array_equal(out["mean"][1], np.full((4,), 1.0))
        assert out["value"] == 3.0


def test_without_a_group(monkeypatch):
    from viettts_tpu_torch.parallel import mesh

    assert mesh.world() == (0, 1)
    batch = {"x": np.zeros((5, 4))}
    assert mesh.shard_batch(batch)["x"].shape == (5, 4)
    with pytest.raises(RuntimeError, match="needs a process group"):
        with mesh.data_parallel():
            pass
    with pytest.raises(ValueError, match="num_processes and process_id"):
        mesh.initialize_distributed("localhost:1234", device="cpu")
    for k in mesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        mesh.initialize_distributed(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.initialize_distributed("localhost:1234", 1, 0, device="cuda")


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]))
