"""The port's multi-process dry run (``tools/multihost_dryrun.py``, the
counterpart of ``tests/test_multihost.py``) as 4 ``gloo`` processes on the
CPU, with a ``file://`` store under pytest's tmp dir, then its sharded
checkpoint restored under other layouts:

* the 4 processes form one group; the global batch's loss equals one
  process's on the whole batch within 1e-6;
* each rank writes its own shard file, none the whole state, and restores
  its slices bitwise;
* 2 processes (this file, run as a script) restore the 4-rank directory,
  where FSDP splits some leaf on another axis than under 4, one process
  in a group of its own restores it, and one without a group: each gives
  the 4-rank state, gathered, bitwise.

Every wait is bounded at 120 s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from viettts_tpu_torch.parallel.mesh import fsdp_shard_axis
from viettts_tpu_torch.tools import multihost_dryrun as dryrun

REPO = Path(__file__).resolve().parents[1]
WORLD, RESTORE_WORLD = 4, 2
TIMEOUT_S = 120


def _run(argvs, env):
    """Start one process per argv; wait for all (bounded); their outputs."""
    procs = [subprocess.Popen([sys.executable, *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for argv in argvs]
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
        assert p.returncode == 0, f"process {r}:\n{out[-4000:]}"
    return outs


def restore_worker(store: str, world: int, rank: int, ckpt_dir: Path, out: Path) -> None:
    """Restore ``ckpt_dir``'s sharded checkpoint under a group of ``world``
    CPU processes with FSDP on; rank 0 writes the restored state, gathered
    whole, and the split axes to ``out``."""
    import torch.distributed as dist

    from viettts_tpu_torch.parallel import mesh
    from viettts_tpu_torch.train.duration import restore_state

    torch.set_num_threads(1)
    device = mesh.initialize_distributed(store, world, rank, device="cpu")
    try:
        optimizer, template, _ = dryrun.build(device, fsdp=True)
        restored = restore_state(ckpt_dir / dryrun.CKPT_NAME, optimizer, template, "orbax")
        whole = dryrun.whole_state(optimizer, restored)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save({"state": whole, "axes": optimizer.axes}, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    ckpt_dir = tmp / "run"
    outs = _run([["-m", "viettts_tpu_torch.tools.multihost_dryrun", "--coordinator", f"file://{tmp / 'store4'}",
                  "--num-processes", str(WORLD), "--process-id", str(r), "--out-dir", str(ckpt_dir),
                  "--device", "cpu"] for r in range(WORLD)], env)
    lines = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    _run([[__file__, f"file://{tmp / f'store{world}'}", str(world), str(r), str(ckpt_dir),
           str(tmp / f"restored{world}.pt")] for world in (RESTORE_WORLD, 1) for r in range(world)], env)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, single_loss = dryrun.train_step("cpu", dryrun.global_batch(WORLD), data_parallel=False)
        optimizer, template, _ = dryrun.build("cpu", fsdp=False)
        from viettts_tpu_torch.train.duration import restore_state

        no_group = dryrun.whole_state(optimizer, restore_state(ckpt_dir / dryrun.CKPT_NAME, optimizer, template,
                                                               "orbax"))
    finally:
        torch.set_num_threads(threads)
    return {"lines": lines, "files": [json.loads((ckpt_dir / f"result_{r}.json").read_text()) for r in range(WORLD)],
            "whole": torch.load(ckpt_dir / "whole_state.pt"), "restored2": torch.load(tmp / "restored2.pt"),
            "restored1": torch.load(tmp / "restored1.pt"), "no_group": no_group, "single_loss": single_loss,
            "dir": ckpt_dir}


def _assert_same_state(got, want):
    assert got.keys() == want.keys()
    for part in want:
        assert got[part].keys() == want[part].keys(), part
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)


def test_four_processes_form_one_group(runs):
    """Each process prints one JSON line (and writes it) with its rank of
    4 in one gloo group, the loss, and a bitwise restore."""
    assert runs["lines"] == runs["files"]
    assert [r["process_id"] for r in runs["lines"]] == list(range(WORLD))
    for r in runs["lines"]:
        assert (r["world_size"], r["backend"], r["device"], r["ok"]) == (WORLD, "gloo", "cpu", True)
        assert r["split_leaves"] > 0


def test_four_rank_loss_matches_one_process(runs):
    losses = [r["loss"] for r in runs["lines"]]
    assert len(set(losses)) == 1  # the all-reduced global loss, on every rank
    assert abs(losses[0] - runs["single_loss"]) <= 1e-6 * abs(runs["single_loss"])


def test_restore_is_bitwise_on_four_ranks(runs):
    assert all(r["restore_bitwise"] for r in runs["lines"])


def test_each_rank_writes_its_own_shards(runs):
    """Rank r wrote ``__r_*.distcp``, and the directory's metadata puts
    each split leaf's parameter and moments in four chunks, the slice of
    rank r in rank r's file; every whole leaf is one chunk, written once."""
    from torch.distributed.checkpoint import FileSystemReader

    names = [r["shard_files"] for r in runs["lines"]]
    assert all(n and all(f.startswith(f"__{r}_") for f in n) for r, n in enumerate(names))
    ckpt = runs["dir"] / "duration_latest_ckpt.dcp"
    assert sorted(p.name for p in ckpt.iterdir()) == sorted([".metadata"] + [f for n in names for f in n])
    metadata = FileSystemReader(ckpt).read_metadata()
    files = {(i.fqn, tuple(i.offset)): info.relative_path for i, info in metadata.storage_data.items()
             if i.offset is not None}  # not the generator state's bytes
    split = 0
    for k, t in runs["whole"]["params"].items():
        axis = fsdp_shard_axis(tuple(t.shape), WORLD, dryrun.FSDP_MIN_SIZE)
        for fqn in (f"variables.params.{k}", f"opt_state.mu.{k}", f"opt_state.nu.{k}"):
            chunks = metadata.state_dict_metadata[fqn].chunks
            if axis is None:
                assert [tuple(c.offsets) for c in chunks] == [(0,) * t.dim()], fqn
                continue
            split += 1
            step = t.shape[axis] // WORLD
            assert sorted(c.offsets[axis] for c in chunks) == [r * step for r in range(WORLD)], fqn
            for c in chunks:
                assert files[(fqn, tuple(c.offsets))] == f"__{c.offsets[axis] // step}_0.distcp", fqn
    assert split > 0


def test_restore_on_two_ranks_reshards(runs):
    """2 processes restore the 4-rank directory into their own FSDP
    layout, in which some leaf splits on another axis than under 4: the
    state gathered from their slices is the 4-rank state, bitwise."""
    axes2 = runs["restored2"]["axes"]
    shapes = {k: tuple(v.shape) for k, v in runs["whole"]["params"].items()}
    assert any(fsdp_shard_axis(s, RESTORE_WORLD, dryrun.FSDP_MIN_SIZE) is not None
               and fsdp_shard_axis(s, WORLD, dryrun.FSDP_MIN_SIZE) not in (None, axes2[k]) for k, s in shapes.items())
    _assert_same_state(runs["restored2"]["state"], runs["whole"])


def test_restore_on_one_rank(runs):
    """One process in a group of its own (FSDP's split leaves whole, as
    one-rank ``DTensor`` shards) restores the 4-rank state."""
    assert any(a is not None for a in runs["restored1"]["axes"].values())
    _assert_same_state(runs["restored1"]["state"], runs["whole"])


def test_restore_without_a_group(runs):
    """One process with no group restores every leaf whole, equal to the
    4-rank state gathered."""
    _assert_same_state(runs["no_group"], runs["whole"])
    assert np.isfinite(runs["single_loss"])


if __name__ == "__main__":
    restore_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]), Path(sys.argv[5]))
