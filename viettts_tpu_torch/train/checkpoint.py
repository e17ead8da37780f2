"""Training checkpoints in the JAX package's native format (counterpart of
the native half of ``viettts_tpu/train/checkpoint.py``).

A checkpoint is one pickle, written atomically:

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
under ``torch_rng``, which the JAX side ignores.  Orbax is a JAX library:
``checkpoint_format="orbax"`` is refused.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from viettts_tpu_torch.checkpoint import JAX_GLOBALS, load_pickle


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
    if fmt == "orbax":
        raise ValueError(
            "checkpoint_format='orbax' needs Orbax, a JAX library; the torch port "
            "writes the native pickle format only"
        )
    if fmt != "pickle":
        raise ValueError(f"unknown checkpoint_format {fmt!r}")


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
