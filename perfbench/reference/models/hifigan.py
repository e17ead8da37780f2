"""HiFi-GAN V1's generator (jik876/hifi-gan ``models.py``, ResBlock1):
conv_pre k=7, per stage leaky_relu(0.1), a transposed conv with JAX's SAME
padding, the mean of the ResBlock1 stacks, then leaky_relu(0.01),
conv_post, tanh.

Seeded as ``bench/seeded.py`` lays it out, but for the resblock
convolutions, which take the configuration's ``resblock_kernel_gain`` where
``bench/seeded.py`` has 0.5, so that the resblocks carry as much of the
signal as the trunk and the vocoder's arithmetic shows in its waveform.
Its stages after conv_pre are the program's kernels K2/K3, whose counts
``stage_counts`` and ``weight_bytes`` give.  ResBlock2 (V3) is another
model module.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.nn import functional as F

from perfbench.harness.weights import Leaf
from perfbench.reference.models import layers


def leaves(sizes: Dict[str, object], gains: Dict[str, float]) -> List[Leaf]:
    if sizes["hifigan.resblock"] != "1":
        raise ValueError(f"the hifigan model module is ResBlock1 only; the configuration states "
                         f"hifigan.resblock={sizes['hifigan.resblock']!r}: name another vocoder module")
    g = ("params",)
    c0, rates, kernels = sizes["hifigan.upsample_initial_channel"], sizes["hifigan.upsample_rates"], sizes[
        "hifigan.upsample_kernel_sizes"]
    rks, rds = sizes["hifigan.resblock_kernel_sizes"], sizes["hifigan.resblock_dilation_sizes"]
    out = layers.conv_leaves(g + ("conv_pre",), 7, sizes["hifigan.mel_dim"], c0)
    for i, (u, k) in enumerate(zip(rates, kernels)):
        ch = c0 // 2 ** (i + 1)
        out += [Leaf(g + (f"ups_{i}", "kernel"), (k, 2 * ch, ch), (k * 2 * ch / u) ** -0.5),
                Leaf(g + (f"ups_{i}", "bias"), (ch,), 0.05)]
        for j, (rk, rd) in enumerate(zip(rks, rds)):
            names = [f"convs1_{m}" for m in range(len(rd))] + [f"convs2_{m}" for m in range(len(rd))]
            for nm in names:
                out += layers.conv_leaves(g + (f"resblock_{i * len(rks) + j}", nm), rk, ch, ch,
                                          gain=gains["resblock_kernel_gain"])
    return out + layers.conv_leaves(g + ("conv_post",), 7, c0 // 2 ** len(rates), 1, gain=2.0)


def wave(tree, sizes, mel: torch.Tensor, dtype: str) -> torch.Tensor:
    """Waveform [B, n_frames * hop] of a log-mel [B, n_frames, D] at the
    vocoder precision ``dtype``: ``float32``; ``bfloat16``, every product's
    operands in bfloat16 (the weights; the mel; each conv's input after its
    leaky_relu; conv_pre's output and bias and each stage's output, which
    are stored) and every sum in float32 (conv_post's input stays float32);
    or ``float8``, the same points in e4m3 with a per-tensor scale to its
    largest value, the control's step below."""
    g = tree["params"]

    def r(t):
        if dtype == "bfloat16":
            return t.to(torch.bfloat16).float()
        if dtype == "float8":
            scale = t.abs().amax().clamp_min(1e-30) / 448.0
            return (t / scale).to(torch.float8_e4m3fn).float() * scale
        return t

    def w(p, bias=False):
        return {"kernel": r(p["kernel"]), "bias": r(p["bias"]) if bias else p["bias"]}

    rks, rds = sizes["hifigan.resblock_kernel_sizes"], sizes["hifigan.resblock_dilation_sizes"]
    pre = w(g["conv_pre"], bias=True)
    x = layers.conv(r(mel).transpose(1, 2), {"kernel": pre["kernel"], "bias": torch.zeros_like(pre["bias"])})
    x = r(r(x) + pre["bias"][:, None])
    rates = sizes["hifigan.upsample_rates"]
    for i, u in enumerate(rates):
        x = layers.conv_transpose_same(r(F.leaky_relu(x, 0.1)), w(g[f"ups_{i}"]), u)
        acc = None
        for j, dils in enumerate(rds):
            blk = g[f"resblock_{i * len(rks) + j}"]
            h = x
            for m, d in enumerate(dils):
                y = layers.conv(r(F.leaky_relu(h, 0.1)), w(blk[f"convs1_{m}"]), d)
                h = layers.conv(r(F.leaky_relu(y, 0.1)), w(blk[f"convs2_{m}"]), 1) + h
            acc = h if acc is None else acc + h
        x = acc / len(rks)
        if i < len(rates) - 1:
            x = r(x)
    x = layers.conv(F.leaky_relu(x, 0.01), w(g["conv_post"]))
    return torch.tanh(x.float())[:, 0]


def generator_flops(sizes, n_frames, batch=1, conv_pre=True):
    """The generator's operations for a mel of ``n_frames``;
    ``conv_pre=False`` leaves out conv_pre, which runs outside the vocoder
    kernels (``utils/flops.py``'s ``generator_flops``)."""
    C0, mel_dim = sizes["hifigan.upsample_initial_channel"], sizes["hifigan.mel_dim"]
    L = n_frames
    f = layers.conv1d_flops(L, mel_dim, C0, 7, batch) if conv_pre else 0
    c_in = C0
    for i, (u, k) in enumerate(zip(sizes["hifigan.upsample_rates"], sizes["hifigan.upsample_kernel_sizes"])):
        c_out = C0 // (2 ** (i + 1))
        L *= u
        f += 2 * batch * L * c_in * c_out * (k / u)
        for rk, rd in zip(sizes["hifigan.resblock_kernel_sizes"], sizes["hifigan.resblock_dilation_sizes"]):
            f += len(rd) * 2 * layers.conv1d_flops(L, c_out, c_out, rk, batch)
        c_in = c_out
    f += layers.conv1d_flops(L, c_in, 1, 7, batch)
    return int(f)


def stage_counts(sizes, frames: int, element_bytes: int = 2):
    """(FLOP, activation bytes) of the stages after conv_pre (prologue, MRF
    convs, conv_post) for ``frames`` frames: each stage's input read and its
    output written once in the storage type."""
    flop = generator_flops(sizes, frames, conv_pre=False)
    C0 = sizes["hifigan.upsample_initial_channel"]
    rates = sizes["hifigan.upsample_rates"]
    bytes_, L, c_in = 0, frames, C0
    for i, u in enumerate(rates):
        c = C0 // 2 ** (i + 1)
        last = i == len(rates) - 1
        bytes_ += element_bytes * (L * c_in + L * u * (1 if last else c))
        L, c_in = L * u, c
    return float(flop), float(bytes_)


def weight_bytes(sizes, element_bytes: int = 2) -> float:
    """Bytes of the stages' weights, read once a call."""
    C0 = sizes["hifigan.upsample_initial_channel"]
    n = 0
    for i, k in enumerate(sizes["hifigan.upsample_kernel_sizes"]):
        c = C0 // 2 ** (i + 1)
        n += k * 2 * c * c + c
        n += sum(len(d) * 2 * (rk * c * c + c) for rk, d in
                 zip(sizes["hifigan.resblock_kernel_sizes"], sizes["hifigan.resblock_dilation_sizes"]))
    n += 7 * (C0 // 2 ** len(sizes["hifigan.upsample_rates"])) + 1
    return float(element_bytes * n)
