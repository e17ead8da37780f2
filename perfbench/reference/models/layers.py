"""Layers that more than one model module uses: their leaves in the seeded
trees, their plain forward passes and their operation counts.

Trees are in the JAX package's layout: dense kernels [in, out], conv
kernels (W, I, O), haiku's LSTM (gates i, g, f, o; +1 on the forget gate).
Leaf paths are relative to the model's checkpoint tree.  Counts are of what
the inputs need: 2 FLOP a multiply-add, element-wise work left out.
"""

from __future__ import annotations

from typing import List

import torch
from torch.nn import functional as F

from perfbench.harness.weights import Leaf

# ---------------------------------------------------------------------------
# leaves: weights at 1/sqrt(fan_in), BatchNorm near identity, biases at 0.05


def lstm_leaves(p, d_in, h) -> List[Leaf]:
    s = (d_in + h) ** -0.5
    return [Leaf(p + ("w_i",), (d_in, 4 * h), s), Leaf(p + ("w_h",), (h, 4 * h), s), Leaf(p + ("b",), (4 * h,), 0.05)]


def dense_leaves(p, i, o, bias=True, gain=1.0) -> List[Leaf]:
    out = [Leaf(p + ("kernel",), (i, o), gain * i ** -0.5)]
    return out + ([Leaf(p + ("bias",), (o,), 0.05)] if bias else [])


def conv_leaves(p, k, i, o, gain=1.0) -> List[Leaf]:
    return [Leaf(p + ("kernel",), (k, i, o), gain * (k * i) ** -0.5), Leaf(p + ("bias",), (o,), 0.05)]


def bn_leaves(p, s, c) -> List[Leaf]:
    return [Leaf(p + ("scale",), (c,), 0.1, 1.0), Leaf(p + ("bias",), (c,), 0.05),
            Leaf(s + ("mean",), (c,), 0.05), Leaf(s + ("var",), (c,), 0.1, 1.0, True)]


def encoder_leaves(vocab, C) -> List[Leaf]:
    """vietTTS's token encoder, under ``params/encoder`` and
    ``batch_stats/encoder``."""
    p, s = ("params", "encoder"), ("batch_stats", "encoder")
    leaves = [Leaf(p + ("embed", "embedding"), (vocab, C), 1.0)]
    for i in range(3):
        leaves += conv_leaves(p + (f"conv_{i}",), 3, C, C) + bn_leaves(p + (f"bn_{i}",), s + (f"bn_{i}",), C)
    return leaves + lstm_leaves(p + ("lstm_fwd",), C, C) + lstm_leaves(p + ("lstm_bwd",), C, C)


# ---------------------------------------------------------------------------
# forward passes


def lstm_cell(gates, c):
    i, g, f, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm(p, x, reverse=False, reset=None):
    """x [B, L, D] -> [B, L, H]; ``reset`` [B, L] zeroes the state before a step."""
    B, L, _ = x.shape
    H = p["w_h"].shape[0]
    xg = x @ p["w_i"] + p["b"]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = [None] * L
    for t in (reversed(range(L)) if reverse else range(L)):
        if reset is not None:
            keep = (~reset[:, t]).to(x.dtype)[:, None]
            h, c = h * keep, c * keep
        h, c = lstm_cell(xg[:, t] + h @ p["w_h"], c)
        out[t] = h
    return torch.stack(out, 1)


def conv(x, p, dilation=1):
    """SAME conv of x [B, C, L] with a (W, I, O) kernel."""
    w = p["kernel"]
    pad = dilation * (w.shape[0] - 1) // 2
    return F.conv1d(x, w.permute(2, 1, 0), p["bias"], padding=pad, dilation=dilation)


def batch_norm(x, p, s, eps=1e-5):
    return (x - s["mean"][:, None]) * torch.rsqrt(s["var"][:, None] + eps) * p["scale"][:, None] + p["bias"][:, None]


def encoder(params, stats, tokens, lengths):
    """vietTTS's token encoder (``nat/model.py``): embedding, 3 x [conv k=3
    SAME, BatchNorm on its running statistics, relu], a bidirectional LSTM
    whose backward direction restarts at each row's last token.
    tokens [B, T] long, lengths [B] -> [B, T, 2C]."""
    x = params["embed"]["embedding"][tokens].transpose(1, 2)
    for i in range(3):
        x = torch.relu(batch_norm(conv(x, params[f"conv_{i}"]), params[f"bn_{i}"], stats[f"bn_{i}"]))
    x = x.transpose(1, 2)
    T = tokens.shape[1]
    reset = torch.arange(T, device=tokens.device)[None, :] >= (lengths[:, None] - 1)
    return torch.cat([lstm(params["lstm_fwd"], x), lstm(params["lstm_bwd"], x, True, reset)], -1)


def conv_transpose_same(x, p, stride):
    """JAX's ``conv_transpose(..., padding='SAME')`` of x [B, C_in, L] with a
    (W, I, O) kernel: the input dilated by ``stride``, padded by
    ``k + s - 2`` split as JAX splits it, correlated with the kernel."""
    w = p["kernel"]
    k = w.shape[0]
    B, C, L = x.shape
    xd = x.new_zeros(B, C, (L - 1) * stride + 1)
    xd[..., ::stride] = x
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    xd = F.pad(xd, (pad_a, pad_len - pad_a))
    return F.conv1d(xd, w.permute(2, 1, 0), p["bias"])


# ---------------------------------------------------------------------------
# operation counts


def conv1d_flops(L, c_in, c_out, k, batch=1):
    return 2 * batch * L * c_in * c_out * k


def dense_flops(n, d_in, d_out, batch=1):
    return 2 * batch * n * d_in * d_out


def lstm_flops(n, d_in, hidden, batch=1):
    return 2 * batch * n * 4 * hidden * (d_in + hidden)


def encoder_flops(n_tokens, dim, batch=1):
    return 3 * conv1d_flops(n_tokens, dim, dim, 3, batch) + 2 * lstm_flops(n_tokens, dim, dim, batch)
