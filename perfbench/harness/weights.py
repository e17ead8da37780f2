"""Seeded weights of the three serving models, made on the device from the
run's seed.

Each model module (``perfbench/reference/models/``) lays out its own tree
as ``Leaf`` entries: its shape, and a normal draw's scale and offset (an
absolute value where a variance must be positive).  The scales follow
``viettts_tpu_torch/bench/seeded.py`` (numpy variable trees in the JAX
package's layout, which the Synthesizer's ``load_variables`` reads), with
the changes each configuration names in its ``assumed`` and sets in its
``weights`` section (the ``gains`` a module reads).

The values come from one ``torch.randn`` on the device with a
``torch.Generator`` seeded from ``--seed``, over the duration, acoustic and
vocoder leaves in that order, scaled and offset leaf by leaf in one
vectorized pass, and copied to the host once.  ``write_trees`` writes them
as native checkpoints for the program to load.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

FORMAT = "viettts_tpu/v1"  # the native checkpoint format the program reads
TREES = {"duration": "duration", "acoustic": "acoustic", "vocoder": "hifigan"}  # role -> the program's checkpoint


class Leaf(NamedTuple):
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    scale: float
    offset: float = 0.0
    absolute: bool = False


def seeded_trees(sizes: Dict[str, object], seed: int, device: torch.device, gains: Dict[str, float], models) -> dict:
    """``{"duration": tree, "acoustic": tree, "hifigan": tree}`` of float32
    numpy leaves, drawn on ``device`` from ``seed``, laid out by ``models``
    (``cells.Models``) for the configuration's ``sizes`` and ``gains``."""
    spec = [leaf._replace(path=(TREES[role],) + leaf.path)
            for role in TREES for leaf in getattr(models, role).leaves(sizes, gains)]
    counts = torch.tensor([int(np.prod(leaf.shape)) for leaf in spec], device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    values = torch.randn(int(counts.sum()), generator=gen, device=device)
    scale = torch.repeat_interleave(torch.tensor([leaf.scale for leaf in spec], device=device), counts)
    offset = torch.repeat_interleave(torch.tensor([leaf.offset for leaf in spec], device=device), counts)
    absolute = torch.repeat_interleave(torch.tensor([leaf.absolute for leaf in spec], device=device), counts)
    values = values * scale + offset
    values = torch.where(absolute, values.abs(), values).cpu().numpy()
    trees: dict = {}
    start = 0
    for leaf in spec:
        n = int(np.prod(leaf.shape))
        node = trees
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = values[start:start + n].reshape(leaf.shape)
        start += n
    return trees


def write_trees(trees: dict, directory: Path) -> Dict[str, Path]:
    """Write each tree into ``directory`` as a native checkpoint:
    ``{kind: path}``."""
    paths = {kind: directory / f"{kind}.pickle" for kind in TREES.values()}
    for kind, path in paths.items():
        with open(path, "wb") as f:
            pickle.dump({"format": FORMAT, "step": 0, "variables": trees[kind]}, f, protocol=4)
    return paths
