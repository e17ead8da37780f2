"""Seeded weights of the three serving models, made on the device from the
run's seed.

Frozen copy of the tree layout and scales of
``viettts_tpu_torch/bench/seeded.py`` (numpy variable trees in the JAX
package's layout, which the Synthesizer's ``load_variables`` reads):
weights at 1/sqrt(fan_in), BatchNorm near identity, biases at 0.05, the
duration head's bias at -2.5 so that tokens last about 80 ms.  Two changes,
named in each configuration's ``assumed`` and set in its ``weights``
section: the duration head's kernel is scaled by ``head_kernel_gain``, so
that every seed speaks at about the same pace and the work a seed asks for
does not move with its weights; and the HiFi-GAN resblock convolutions take
``resblock_kernel_gain`` where ``bench/seeded.py`` has 0.5, so that the
resblocks carry as much of the signal as the trunk and the vocoder's
arithmetic shows in its waveform.

The values come from one ``torch.randn`` on the device with a
``torch.Generator`` seeded from ``--seed``, scaled and offset leaf by leaf
in one vectorized pass, and copied to the host once.  ``write_trees``
writes them as native checkpoints for the program to load.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

FORMAT = "viettts_tpu/v1"  # the native checkpoint format the program reads


class Leaf(NamedTuple):
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    scale: float
    offset: float = 0.0
    absolute: bool = False


def _lstm(p, d_in, h) -> List[Leaf]:
    s = (d_in + h) ** -0.5
    return [Leaf(p + ("w_i",), (d_in, 4 * h), s), Leaf(p + ("w_h",), (h, 4 * h), s), Leaf(p + ("b",), (4 * h,), 0.05)]


def _dense(p, i, o, bias=True, gain=1.0) -> List[Leaf]:
    out = [Leaf(p + ("kernel",), (i, o), gain * i ** -0.5)]
    return out + ([Leaf(p + ("bias",), (o,), 0.05)] if bias else [])


def _conv(p, k, i, o, gain=1.0) -> List[Leaf]:
    return [Leaf(p + ("kernel",), (k, i, o), gain * (k * i) ** -0.5), Leaf(p + ("bias",), (o,), 0.05)]


def _bn(p, s, c) -> List[Leaf]:
    return [Leaf(p + ("scale",), (c,), 0.1, 1.0), Leaf(p + ("bias",), (c,), 0.05),
            Leaf(s + ("mean",), (c,), 0.05), Leaf(s + ("var",), (c,), 0.1, 1.0, True)]


def _encoder(root, vocab, C) -> List[Leaf]:
    p, s = (root, "params", "encoder"), (root, "batch_stats", "encoder")
    leaves = [Leaf(p + ("embed", "embedding"), (vocab, C), 1.0)]
    for i in range(3):
        leaves += _conv(p + (f"conv_{i}",), 3, C, C) + _bn(p + (f"bn_{i}",), s + (f"bn_{i}",), C)
    return leaves + _lstm(p + ("lstm_fwd",), C, C) + _lstm(p + ("lstm_bwd",), C, C)


def leaves(sizes: Dict[str, int], gains: Dict[str, float]) -> List[Leaf]:
    """Every leaf of the three trees, in ``bench/seeded.py``'s order, for the
    widths in ``sizes`` (the configuration file's keys) and the configuration's
    ``gains`` (its ``weights`` section)."""
    head_kernel_gain, resblock_kernel_gain = gains["head_kernel_gain"], gains["resblock_kernel_gain"]
    dv, dd = sizes["duration.vocab_size"], sizes["duration.lstm_dim"]
    out = _encoder("duration", dv, dd)
    out += _dense(("duration", "params", "proj_0"), 2 * dd, dd)
    out += [Leaf(("duration", "params", "proj_1", "kernel"), (dd, 1), head_kernel_gain * dd ** -0.5),
            Leaf(("duration", "params", "proj_1", "bias"), (1,), 0.0, -2.5)]

    C, P = 2 * sizes["acoustic.encoder_dim"], sizes["acoustic.prenet_dim"]
    H, D, Q = sizes["acoustic.decoder_dim"], sizes["acoustic.mel_dim"], sizes["acoustic.postnet_dim"]
    out += _encoder("acoustic", sizes["acoustic.vocab_size"], sizes["acoustic.encoder_dim"])
    p = ("acoustic", "params")
    out += _lstm(p + ("decoder_lstm1",), C + P, H) + _lstm(p + ("decoder_lstm2",), C + P + H, H)
    out += _dense(p + ("prenet_fc1",), D, P, bias=False) + _dense(p + ("prenet_fc2",), P, P, bias=False)
    out += _dense(p + ("projection",), 2 * H, D)
    dims = [D] + [Q] * 4 + [D]
    for i in range(5):
        out += _conv(p + (f"postnet_conv_{i}",), 5, dims[i], dims[i + 1])
    for i in range(4):
        out += _bn(p + (f"postnet_bn_{i}",), ("acoustic", "batch_stats", f"postnet_bn_{i}"), Q)

    g = ("hifigan", "params")
    c0, rates, kernels = sizes["hifigan.upsample_initial_channel"], sizes["hifigan.upsample_rates"], sizes[
        "hifigan.upsample_kernel_sizes"]
    rks, rds = sizes["hifigan.resblock_kernel_sizes"], sizes["hifigan.resblock_dilation_sizes"]
    out += _conv(g + ("conv_pre",), 7, sizes["hifigan.mel_dim"], c0)
    for i, (u, k) in enumerate(zip(rates, kernels)):
        ch = c0 // 2 ** (i + 1)
        out += [Leaf(g + (f"ups_{i}", "kernel"), (k, 2 * ch, ch), (k * 2 * ch / u) ** -0.5),
                Leaf(g + (f"ups_{i}", "bias"), (ch,), 0.05)]
        for j, (rk, rd) in enumerate(zip(rks, rds)):
            names = [f"convs1_{m}" for m in range(len(rd))] + [f"convs2_{m}" for m in range(len(rd))]
            for nm in names:
                out += _conv(g + (f"resblock_{i * len(rks) + j}", nm), rk, ch, ch, gain=resblock_kernel_gain)
    out += _conv(g + ("conv_post",), 7, c0 // 2 ** len(rates), 1, gain=2.0)
    return out


def seeded_trees(sizes: Dict[str, int], seed: int, device: torch.device, gains: Dict[str, float]) -> dict:
    """``{"duration": tree, "acoustic": tree, "hifigan": tree}`` of float32
    numpy leaves, drawn on ``device`` from ``seed``."""
    spec = leaves(sizes, gains)
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
    paths = {kind: directory / f"{kind}.pickle" for kind in ("duration", "acoustic", "hifigan")}
    for kind, path in paths.items():
        with open(path, "wb") as f:
            pickle.dump({"format": FORMAT, "step": 0, "variables": trees[kind]}, f, protocol=4)
    return paths
