"""Training checkpoints (counterpart of ``viettts_tpu/train/checkpoint.py``).

``checkpoint_format="pickle"``: one pickle in the JAX package's native
format, written atomically:

    {"format": "viettts_tpu/v1", "step", "variables": {"params",
     "batch_stats"}, "opt_state", "rng", "torch_rng"}

with the JAX package's trees (``checkpoint.jax_tree``) and optax's
optimizer-state tree, so the JAX trainers' ``restore_state`` resumes a
port-written file and the port resumes a JAX-written one.  The pickle
names ``viettts_tpu.ops.rnn.LSTMParams`` and optax's state classes
(``checkpoint.JAX_GLOBALS``) without importing either: ``_JaxPickler``
writes those globals itself, since a plain ``pickle.Pickler`` looks each
class up.  ``rng`` is a uint32[2] key (the generator's seed, as
``jax.random.PRNGKey`` lays it out); the generator's own state rides
under ``torch_rng``, which the JAX side ignores.

``checkpoint_format="orbax"``: JAX's sharded, resumable checkpoint, here
a ``torch.distributed.checkpoint`` directory ``<stem>.dcp`` beside the
pickle path (``sharded_dir``), which every process of the group writes
its own part of (``save_sharded``).  A leaf that FSDP splits goes in as
this rank's slice, a ``DTensor`` sharded on its axis over the 1-D mesh of
the default group (``shard_leaf``); every other tensor goes in whole and
is written once.  ``load_sharded`` fills a template built for the current
layout, so a directory written under N ranks restores under M, with the
split axes of either, or without a process group.  The directory holds the
port's own tensors (its names and layouts), not JAX's: neither package
reads the other's sharded directory, and the pickle is the interchange
format.
"""

from __future__ import annotations

import pickle
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from viettts_tpu_torch.checkpoint import JAX_GLOBALS, load_pickle

FORMATS = ("pickle", "orbax")


class _JaxPickler(pickle._Pickler):
    """The pure-Python pickler with the stand-ins of ``JAX_GLOBALS``
    written under their JAX-side names."""

    def save_global(self, obj, name=None):
        target = JAX_GLOBALS.get(obj) if isinstance(obj, type) else None
        if target is None:
            return super().save_global(obj, name)
        module, qualname = target
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode("utf-8"))
        self.memoize(obj)


def save_checkpoint(path: str | Path, payload: Dict[str, Any]) -> None:
    """Atomically pickle a checkpoint dict of numpy trees."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        _JaxPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
    tmp.replace(path)


def load_checkpoint(path: str | Path) -> Optional[Dict[str, Any]]:
    """A checkpoint dict, or None when ``path`` does not exist."""
    path = Path(path)
    return load_pickle(path) if path.exists() else None


def check_format(fmt: str) -> None:
    if fmt not in FORMATS:
        raise ValueError(f"unknown checkpoint_format {fmt!r}: one of {FORMATS}")


def sharded_dir(path: str | Path) -> Path:
    """The sharded directory of the checkpoint whose pickle is ``path``:
    ``<stem>.dcp`` (JAX's is ``<stem>.orbax``)."""
    return Path(path).with_suffix(".dcp")


def shard_leaf(t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """``t``, this rank's slice on ``axis`` of a leaf split evenly over the
    default group, as a ``DTensor`` sharing its storage; ``t`` itself when
    ``axis`` is None (a whole leaf)."""
    if axis is None:
        return t
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    mesh = init_device_mesh(t.device.type, (dist.get_world_size(),))  # the default group, no new one
    return DTensor.from_local(t, mesh, [Shard(axis)], run_check=False)


def save_sharded(dirpath: str | Path, state_dict: Dict[str, Any]) -> None:
    """Write ``state_dict`` (nested dicts of tensors, ``shard_leaf``
    slices and small picklable values) to the directory ``dirpath``.
    Under a process group every rank calls it and writes its own part:
    its slices of the split leaves, and its share of the whole tensors,
    each of which is written once.  Atomic: the ranks write
    ``<dirpath>.tmp``, which rank 0 renames to ``dirpath`` once all have
    finished."""
    import torch.distributed.checkpoint as dcp

    dirpath = Path(dirpath)
    tmp, old = (dirpath.with_name(dirpath.name + suffix) for suffix in (".tmp", ".old"))
    grouped = dist.is_initialized()
    main = not grouped or dist.get_rank() == 0
    if main:  # what a failed save left behind
        shutil.rmtree(tmp, ignore_errors=True)
        dirpath.parent.mkdir(parents=True, exist_ok=True)
    if grouped:
        dist.barrier()
    dcp.save(state_dict, checkpoint_id=tmp, no_dist=not grouped)  # returns once every rank's part is written
    if main:  # at every point ``dirpath`` or ``old`` holds a whole checkpoint
        if dirpath.exists():
            shutil.rmtree(old, ignore_errors=True)
            dirpath.rename(old)
        tmp.rename(dirpath)
        shutil.rmtree(old, ignore_errors=True)
    if grouped:
        dist.barrier()


def load_sharded(dirpath: str | Path, template: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Fill ``template`` (``save_sharded``'s tree, laid out for this run:
    ``shard_leaf`` slices and whole tensors) in place from ``dirpath`` and
    return it; under a process group every rank calls it.  None when there
    is no such directory; a JAX ``<stem>.orbax`` directory in its place
    raises, since the port cannot read it."""
    import torch.distributed.checkpoint as dcp

    dirpath = Path(dirpath)
    if not dirpath.exists():
        old = dirpath.with_name(dirpath.name + ".old")  # a save stopped between its two renames
        if not old.exists():
            orbax = dirpath.with_suffix(".orbax")
            if orbax.exists():
                raise ValueError(
                    f"{orbax} is the JAX package's Orbax checkpoint, which the torch port cannot read (it "
                    f"resumes from {dirpath.name}); convert it with the JAX package (restore_state or "
                    "restore_vocoder_state with fmt='orbax', then save with fmt='pickle') and resume from "
                    "the pickle with checkpoint_format='pickle'"
                )
            return None
        dirpath = old
    dcp.load(template, checkpoint_id=dirpath, no_dist=not dist.is_initialized())
    return template


def jax_key(generator: torch.Generator) -> np.ndarray:
    """The uint32[2] key of ``jax.random.PRNGKey(seed)`` for the
    generator's seed."""
    seed = generator.initial_seed()
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def generator_state(generator: torch.Generator) -> Dict[str, Any]:
    return {"device": generator.device.type, "state": generator.get_state().numpy().copy()}


def restore_generator(generator: torch.Generator, dic: Dict[str, Any]) -> None:
    """Resume ``generator`` from a checkpoint: from its own state when the
    file holds one for this device type, else seeded from the JAX key."""
    saved = dic.get("torch_rng")
    if saved is not None and saved["device"] == generator.device.type:
        generator.set_state(torch.from_numpy(np.asarray(saved["state"], np.uint8)))
        return
    key = np.asarray(dic["rng"], np.uint32).reshape(-1)
    generator.manual_seed((int(key[0]) << 32) | int(key[-1]))
