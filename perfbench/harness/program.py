"""The system under test, built as a user builds it: the program's own
``Config`` with the configuration file's sizes set, its ``Synthesizer``
loading the seeded checkpoints, nothing else of the program touched."""

from __future__ import annotations

import dataclasses
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

import torch

from perfbench.harness.weights import write_trees

# the configuration file's keys that are the program's config fields
SECTIONS = ("dsp.", "duration.", "acoustic.", "hifigan.", "data.")


def _literal(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return "(" + ",".join(str(x) for x in v) + ")"
    return str(v)


def _plain(v):
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _nested(v) -> bool:
    return isinstance(v, list) and bool(v) and isinstance(v[0], list)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def program_config(sizes: Dict[str, object], overrides: Sequence[str] = ()):
    """The program's ``Config`` with every key of ``sizes`` set: scalars and
    flat tuples through its own override parser, then tuples of tuples,
    which the parser cannot read, with ``dataclasses.replace`` on their
    section; each key is then read back and must equal the file's."""
    from viettts_tpu_torch.config import Config, apply_overrides

    keys = [k for k in sizes if k.startswith(SECTIONS)]
    scalars = [f"{k}={_literal(sizes[k])}" for k in keys if not _nested(sizes[k])]
    cfg = apply_overrides(Config(), scalars + list(overrides))
    for k in keys:
        if _nested(sizes[k]):
            section, field = k.split(".")
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section),
                                                                           **{field: _tuples(sizes[k])})})
    for k in keys:
        section, field = k.split(".")
        got = _plain(getattr(getattr(cfg, section), field))
        if got != _plain(sizes[k]):
            raise ValueError(f"configuration key {k}: the program runs {got!r}, the file says {sizes[k]!r}")
    return cfg


class Program:
    """A Synthesizer on seeded trees, and the directory (under ``TMPDIR``)
    its checkpoints were written to."""

    def __init__(self, sizes: Dict[str, object], trees: dict, device: torch.device, prenet_seed: int,
                 overrides: Sequence[str] = ()):
        from viettts_tpu_torch.infer.pipeline import Synthesizer

        self.cfg = program_config(sizes, overrides)
        self._tmp = tempfile.TemporaryDirectory(prefix="perfbench_")
        paths = write_trees(trees, Path(self._tmp.name))
        self.synth = Synthesizer(self.cfg, duration_ckpt=paths["duration"], acoustic_ckpt=paths["acoustic"],
                                 hifigan_ckpt=paths["hifigan"], prenet_seed=prenet_seed, device=device)

    def close(self) -> None:
        self.synth = None
        self._tmp.cleanup()


def warm(synth, warmup: List[dict]) -> None:
    """``Synthesizer.warmup`` once for each of the traffic file's ``warmup``
    entries (each its batch sizes, token buckets and frame buckets)."""
    for w in warmup:
        synth.warmup(batch_sizes=tuple(w["batch_sizes"]), token_buckets=tuple(w["token_buckets"]),
                     frame_buckets=w.get("frame_buckets"))
