"""Data-parallel and FSDP layout over ``torch.distributed`` (counterpart of
``viettts_tpu/parallel/mesh.py``).

JAX builds one ``Mesh`` over every device and lets XLA insert the
collectives.  PyTorch runs one process per device (``torchrun
--nproc-per-node N``), so here the mesh is the default process group:
rank ``r`` of ``W`` holds rows ``[r*B/W, (r+1)*B/W)`` of every global batch
and the collectives are explicit.

* ``initialize_distributed`` joins the group (``nccl`` for CUDA, ``gloo``
  for the CPU); ``world()`` is (rank, world size), (0, 1) without a group.
* ``shard_batch`` takes this rank's rows; ``check_data_parallel`` holds a
  trainer's ``num_devices`` and global batch to the group.  JAX's
  ``mesh_for_batch`` shrinks the mesh when the batch is indivisible;
  processes cannot shrink, so the port raises instead.
* Inside ``data_parallel()`` the models see their rows of one global batch
  as JAX's ``jit`` sees the whole of it: ``BatchNorm`` all-reduces its
  moment sums (with autograd), ``rand_rows`` draws a dropout or masking
  draw at the global batch shape from the replicated generator and keeps
  this rank's rows, and ``global_sum`` gives a masked loss its global
  denominator.  Every collective runs whatever the world size, one rank
  included.
* ``all_reduce_grads`` sums (or averages) gradients over one flat bucket
  per dtype; ``fsdp_shard_axis`` is JAX's ``fsdp_sharding_for`` rule, and
  ``all_gather_shard`` / ``reduce_scatter_shard`` move FSDP shards.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from typing import Any, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

OPS = ("sum", "mean")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> torch.device:
    """Join the default process group and return this rank's device.

    With no arguments it reads ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); otherwise
    ``coordinator_address`` is ``host:port`` (``tcp://``) or a ``tcp://``
    or ``file://`` URL, with ``num_processes`` and ``process_id``.  The
    backend is ``nccl`` for CUDA and ``gloo`` for the CPU; a CUDA rank's
    device is ``cuda:{LOCAL_RANK}`` (the process id when ``LOCAL_RANK`` is
    unset), made current.  Nothing falls back: no card, no group."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available; pass device='cpu' for gloo")
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    if coordinator_address is None:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize_distributed() without arguments reads torchrun's environment, but {missing} "
                "are not set: launch under torchrun or pass coordinator_address, num_processes and process_id"
            )
        init_method, rank, world_size = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        rank, world_size = process_id, num_processes
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no card: {torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return device


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def check_data_parallel(num_devices: int, batch_size: int, fsdp: bool = False) -> bool:
    """Hold a trainer's ``train.num_devices``, ``train.fsdp`` and global
    ``batch_size`` to the process group; True when training runs under
    one (its collectives then run, one rank included).  Without a group
    only one device is allowed; ``-1`` means the world size."""
    if not dist.is_initialized():
        if num_devices not in (-1, 1) or fsdp:
            raise ValueError(
                f"train.num_devices={num_devices}, train.fsdp={fsdp} need one process per device: launch "
                "under torchrun --nproc-per-node N -m viettts_tpu_torch.train.<name> ... "
                "--set train.num_devices=N"
            )
        return False
    _, w = world()
    if num_devices not in (-1, w):
        raise ValueError(f"train.num_devices={num_devices} but the process group has {w} ranks")
    if batch_size % w:
        raise ValueError(
            f"global batch {batch_size} is not divisible by the world size {w}; processes cannot shrink "
            "the mesh (JAX's mesh_for_batch does): choose a batch that the ranks divide"
        )
    return True


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(batch: Any, batch_axis: int = 0, on_indivisible: str = "error") -> Any:
    """This rank's rows of a global batch (a NamedTuple, tuple, list or
    dict of numpy arrays or tensors): rows ``[r*B/W, (r+1)*B/W)`` of every
    leaf that has ``batch_axis``, as views.  Leaves without it pass
    through.  A batch axis that the world size does not divide raises, as
    silently replicating it would train on each example W times; pass
    ``on_indivisible="replicate"`` where every rank should see the whole
    batch (validation)."""
    if on_indivisible not in ("error", "replicate"):
        raise ValueError(f"on_indivisible={on_indivisible!r}")
    rank, w = world()

    def take(x):
        shape = getattr(x, "shape", None)
        if shape is None or len(shape) <= batch_axis:
            return x
        n = shape[batch_axis]
        if n % w:
            if on_indivisible == "error":
                raise ValueError(
                    f"batch axis {batch_axis} of shape {tuple(shape)} is not divisible by the data-parallel "
                    f"world size {w}; pad or drop the remainder before shard_batch(), or pass "
                    'on_indivisible="replicate" for eval batches'
                )
            return x
        k = n // w
        index = (slice(None),) * batch_axis + (slice(rank * k, (rank + 1) * k),)
        return x[index]

    return _tree_map(take, batch)


def fsdp_shard_axis(shape: Sequence[int], n: int, min_size: int = 2**16) -> Optional[int]:
    """The axis an ``n``-way FSDP layout splits a leaf of ``shape`` on: the
    largest axis that ``n`` divides (the first of equals), for leaves of at
    least ``min_size`` elements; None (replicated) otherwise."""
    if math.prod(shape) < min_size:
        return None
    for axis in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[axis] % n == 0:
            return axis
    return None


def shard_of(t: torch.Tensor, axis: int) -> torch.Tensor:
    """This rank's slice of ``t`` on ``axis`` (a view)."""
    rank, w = world()
    k = t.shape[axis] // w
    return t.narrow(axis, rank * k, k)


def all_gather_shard(shard: torch.Tensor, axis: int) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` on ``axis``."""
    src = shard.movedim(axis, 0).contiguous()
    out = src.new_empty((dist.get_world_size() * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src)
    return out.movedim(0, axis)


def reduce_scatter_shard(full: torch.Tensor, axis: int) -> torch.Tensor:
    """This rank's slice on ``axis`` of the sum of ``full`` over the ranks."""
    src = full.movedim(axis, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(),) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src)
    return out.movedim(0, axis)


def all_reduce_grads(grads: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
    """Each gradient summed (``"sum"``) or averaged (``"mean"``) over the
    ranks, through one flat bucket per dtype."""
    if op not in OPS:
        raise ValueError(f"op={op!r}")
    out = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(out):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        if op == "mean":
            flat /= dist.get_world_size()
        for i, piece in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = piece.view_as(out[i])
    return out


def all_reduce_value(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """A detached copy of ``x`` summed or averaged over the ranks (a loss
    or metric to report)."""
    if op not in OPS:
        raise ValueError(f"op={op!r}")
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / dist.get_world_size() if op == "mean" else x


class Rows(NamedTuple):
    rank: int
    world: int


_ROWS: contextvars.ContextVar[Optional[Rows]] = contextvars.ContextVar("viettts_batch_rows", default=None)


@contextlib.contextmanager
def data_parallel() -> Iterator[Rows]:
    """Within: every batch the models see is this rank's rows of a global
    batch (``BatchNorm``, ``rand_rows`` and ``global_sum`` act on the
    global batch).  Needs a process group."""
    if not dist.is_initialized():
        raise RuntimeError("data_parallel() needs a process group (initialize_distributed)")
    token = _ROWS.set(Rows(*world()))
    try:
        yield _ROWS.get()
    finally:
        _ROWS.reset(token)


def batch_rows() -> Optional[Rows]:
    """(rank, world) inside ``data_parallel()``, None outside."""
    return _ROWS.get()


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator], device, batch_axis: int = 0) -> torch.Tensor:
    """``torch.rand(shape)``; inside ``data_parallel()`` the draw is made
    at the global batch shape (``shape[batch_axis] * world``) and this
    rank's rows are kept, so the ranks together draw what one device
    draws and their generators advance in lockstep."""
    rows = _ROWS.get()
    if rows is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    n = shape[batch_axis]
    full = list(shape)
    full[batch_axis] = n * rows.world
    return torch.rand(full, generator=generator, device=device).narrow(batch_axis, rows.rank * n, n)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, summed over the ranks inside ``data_parallel()`` (through
    autograd when it needs a gradient: the backward all-reduces too)."""
    if _ROWS.get() is None:
        return x
    if x.requires_grad:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x)
    x = x.clone()
    dist.all_reduce(x)
    return x
