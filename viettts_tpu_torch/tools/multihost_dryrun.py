"""Multi-process dry run of the port's training layer (counterpart of
``scripts/multihost_dryrun.py``).

    python -m viettts_tpu_torch.tools.multihost_dryrun --coordinator file:///tmp/store \\
        --num-processes N --process-id {0..N-1} --out-dir OUT [--device cpu]
    torchrun --nproc-per-node N -m viettts_tpu_torch.tools.multihost_dryrun --out-dir OUT [--device cpu]

JAX's dry run joins 2 processes of 4 virtual devices into one 8-device
global mesh.  The port's mesh is the process group, one process per device
(``parallel/mesh.py``), so here it is N processes.  Each joins the group
through ``mesh.initialize_distributed`` (``--coordinator`` is ``host:port``
or a ``tcp://`` or ``file://`` URL; without it, ``torchrun``'s
environment), takes its rows of one global batch (``shard_batch``, 2 rows a
process) and runs one data-parallel FSDP step of a small ``DurationModel``
with the duration trainer's loss, token masking and dropout on: the
gradients' reduce-scatter and all-reduce cross the process boundary.  It
saves the state in the sharded checkpoint format (every process writes its
own slices, ``train/checkpoint.py``) and restores it into a fresh model
under the same group, which must give the same bits.  Rank 0 also writes
the whole state, gathered, to ``whole_state.pt``, for holding restores
under other layouts to it.

Each process prints one JSON line (also written to
``result_{process_id}.json``): its loss (the global batch's), the world
size, whether the restore was bitwise, and the shard files it wrote.  The
exit code is 1 when the restore was not bitwise or the loss not finite.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from viettts_tpu_torch.config import DurationModelConfig
from viettts_tpu_torch.data.loader import to_device
from viettts_tpu_torch.models.duration import DurationModel
from viettts_tpu_torch.models.layers import batch_stats
from viettts_tpu_torch.parallel import mesh
from viettts_tpu_torch.train.checkpoint import sharded_dir
from viettts_tpu_torch.train.common import (
    FsdpClipAdamW,
    TrainState,
    init_train_state,
    make_optimizer,
    make_update_fn,
    whole_opt_state,
    whole_params,
)
from viettts_tpu_torch.train.duration import make_loss_fn, restore_state, save_native_ckpt
from viettts_tpu_torch.types import DurationBatch

# 90 tokens (2 mod 4): the embedding [90, 16] splits on its rows under 2
# processes and on its columns under 4, so a restore across the two
# reshards on another axis
VOCAB, LSTM_DIM = 90, 16
FSDP_MIN_SIZE = 256  # every matrix of this width splits; the vectors stay whole
ROWS, TOKENS, SEED = 2, 16, 0
CKPT_NAME = "duration_latest_ckpt.pickle"


def build(device, fsdp: bool) -> Tuple[FsdpClipAdamW, TrainState, DurationModel]:
    """The seeded model on ``device``, its optimizer (FSDP over the group
    with ``fsdp``: ``init`` splits the parameters) and a fresh state."""
    model = DurationModel(DurationModelConfig(vocab_size=VOCAB, lstm_dim=LSTM_DIM))
    model.init_params(torch.Generator().manual_seed(SEED))
    model.to(device)
    optimizer = make_optimizer(1e-3)
    if fsdp:
        optimizer = FsdpClipAdamW(optimizer, min_size=FSDP_MIN_SIZE)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), optimizer,
                             torch.Generator(device).manual_seed(SEED))
    return optimizer, state, model


def global_batch(world: int) -> DurationBatch:
    """``ROWS`` rows per process of seeded tokens with ragged lengths (the
    loss's denominator is the global batch's)."""
    rng = np.random.RandomState(SEED)
    B = ROWS * world
    lengths = rng.randint(TOKENS // 2, TOKENS + 1, B).astype(np.int32)
    toks = rng.randint(4, 20, (B, TOKENS)).astype(np.int32)
    durs = rng.rand(B, TOKENS).astype(np.float32)
    for i, n in enumerate(lengths):
        toks[i, n:], durs[i, n:] = 0, 0.0
    return DurationBatch(toks, lengths, durs)


def train_step(device, batch: DurationBatch, data_parallel: bool):
    """One step of ``build``'s model on ``batch`` (the global batch; with
    ``data_parallel`` this process takes its rows and FSDP is on).
    Returns (optimizer, state, the global batch's loss)."""
    optimizer, state, model = build(device, fsdp=data_parallel)
    update = make_update_fn(make_loss_fn(model, 0.1, train=True), optimizer, data_parallel=data_parallel)
    rows = mesh.shard_batch(batch) if data_parallel else batch
    state, loss = update(state, [to_device(rows, torch.device(device))])
    return optimizer, state, float(loss)


def whole_state(optimizer, state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state's tensors whole, on the host (an FSDP ``optimizer``
    gathers: a collective, every rank calls it)."""
    moments = whole_opt_state(optimizer, state.opt_state)

    def host(named):
        return {k: v.detach().cpu() for k, v in named.items()}

    return {"params": host(whole_params(optimizer, state.params)), "batch_stats": host(state.batch_stats),
            "mu": host(moments.mu), "nu": host(moments.nu),
            "counts": {"step": torch.tensor(state.step), "count": torch.tensor(state.opt_state.count)}}


def same_state(a: TrainState, b: TrainState) -> bool:
    """Bitwise equal tensors, counts and generator state."""
    pairs = [(a.params, b.params), (a.batch_stats, b.batch_stats), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    return (all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x) for x, y in pairs)
            and (a.step, a.opt_state.count) == (b.step, b.opt_state.count)
            and torch.equal(a.rng.get_state(), b.rng.get_state()))


def main(argv=None) -> int:
    from argparse import ArgumentParser

    import torch.distributed as dist

    parser = ArgumentParser(description="Multi-process dry run: one FSDP step and a sharded checkpoint round trip")
    parser.add_argument("--coordinator", default=None,
                        help="host:port, tcp:// or file:// rendezvous; omitted under torchrun")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--out-dir", type=Path, required=True)
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for gloo)")
    args = parser.parse_args(argv)

    device = mesh.initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    try:
        rank, world = mesh.world()
        optimizer, state, loss = train_step(device, global_batch(world), data_parallel=True)
        path = args.out_dir / CKPT_NAME
        t0 = time.perf_counter()
        save_native_ckpt(path, state, "orbax", optimizer)
        save_ms = 1e3 * (time.perf_counter() - t0)
        fresh_optimizer, template, _ = build(device, fsdp=True)
        restored: Optional[TrainState] = restore_state(path, fresh_optimizer, template, "orbax")
        bitwise = restored is not None and same_state(restored, state)
        whole = whole_state(optimizer, state)
        if rank == 0:
            torch.save(whole, args.out_dir / "whole_state.pt")
        files = sorted(f for f in sharded_dir(path).iterdir() if f.name.startswith(f"__{rank}_"))
        result = {"process_id": rank, "world_size": world, "backend": dist.get_backend(), "device": str(device),
                  "loss": loss, "restore_bitwise": bitwise, "save_ms": save_ms,
                  "split_leaves": sum(a is not None for a in optimizer.axes.values()),
                  "shard_files": [f.name for f in files], "shard_bytes": sum(f.stat().st_size for f in files),
                  "ok": bitwise and math.isfinite(loss)}
    finally:
        dist.destroy_process_group()
    (args.out_dir / f"result_{rank}.json").write_text(json.dumps(result))
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
