"""Autoregressive acoustic-decoder loop: CUDA kernel K1 and its plain twin.

Counterpart of ``viettts_tpu/ops/ar_decoder.py::ar_decode``.  Per frame t:

    p   = relu(relu(mel_{t-1} @ Wfc1) * keep1_t * s @ Wfc2) * keep2_t * s
    g1  = g1c_t + [p, h1] @ W1m          ->  (h1, c1)   haiku LSTM gate math
    g2  = g2c_t + [p, h1', h2] @ W2m     ->  (h2, c2)
    mel_t = [h1', h2'] @ Wp + b          (fed back to the next frame)

``W1m = [W1p; Wh1]`` and ``W2m = [W2p; W2h1; Wh2]`` are merged once when the
acoustic model is loaded (``AcousticModel.merge_decoder_weights``).

``ar_decode`` runs ``csrc/ar_decoder.cu`` on CUDA tensors and
``ar_decode_plain`` (a Python frame loop over ``torch.matmul``) on CPU
tensors; any other device raises.  ``ar_decode.launches`` counts kernel
launches and ``ar_decode.plain_calls`` counts calls of the twin.
"""

from __future__ import annotations

import torch

from viettts_tpu_torch.ops import _build
from viettts_tpu_torch.ops.rnn import apply_gates


def ar_decode_plain(
    g1c, g2c, keep1, keep2, k_fc1, k_fc2, w1m, w2m, proj_kernel, proj_bias,
    dropout_scale: float,
) -> torch.Tensor:
    """Plain PyTorch twin of the decode kernel; returns mel [B, L, D]."""
    ar_decode.plain_calls += 1
    B, L, H4 = g1c.shape
    H = H4 // 4
    D = proj_kernel.shape[1]
    h1 = g1c.new_zeros(B, H)
    c1 = g1c.new_zeros(B, H)
    h2 = g1c.new_zeros(B, H)
    c2 = g1c.new_zeros(B, H)
    mel = g1c.new_zeros(B, D)
    out = []
    for t in range(L):
        p = torch.relu(mel @ k_fc1) * keep1[t] * dropout_scale
        p = torch.relu(p @ k_fc2) * keep2[t] * dropout_scale
        h1, c1 = apply_gates(g1c[:, t] + torch.cat([p, h1], 1) @ w1m, c1)
        h2, c2 = apply_gates(g2c[:, t] + torch.cat([p, h1, h2], 1) @ w2m, c2)
        mel = torch.cat([h1, h2], 1) @ proj_kernel + proj_bias
        out.append(mel)
    return torch.stack(out, dim=1)


def _check(g1c, g2c, keep1, keep2, k_fc1, k_fc2, w1m, w2m, proj_kernel, proj_bias):
    B, L, H4 = g1c.shape
    H, P, D = H4 // 4, k_fc2.shape[0], proj_kernel.shape[1]
    shapes = {
        "g1c": (g1c, (B, L, 4 * H)),
        "g2c": (g2c, (B, L, 4 * H)),
        "keep1": (keep1, (L, B, P)),
        "keep2": (keep2, (L, B, P)),
        "k_fc1": (k_fc1, (D, P)),
        "k_fc2": (k_fc2, (P, P)),
        "w1m": (w1m, (P + H, 4 * H)),
        "w2m": (w2m, (P + 2 * H, 4 * H)),
        "proj_kernel": (proj_kernel, (2 * H, D)),
        "proj_bias": (proj_bias, (D,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ar_decode: {name} has shape {tuple(t.shape)}, want {shape}")
        if t.device != g1c.device:
            raise ValueError(f"ar_decode: {name} is on {t.device}, g1c on {g1c.device}")
        want = torch.bool if name.startswith("keep") else torch.float32
        if t.dtype != want:
            raise ValueError(f"ar_decode: {name} is {t.dtype}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"ar_decode: {name} is not contiguous")
    return B, L, H, P, D


def ar_decode(
    g1c: torch.Tensor,  # [B, L, 4H] f32 conditioning gates, layer 1
    g2c: torch.Tensor,  # [B, L, 4H] f32 conditioning gates, layer 2
    keep1: torch.Tensor,  # [L, B, P] bool prenet dropout keep mask 1
    keep2: torch.Tensor,  # [L, B, P] bool
    k_fc1: torch.Tensor,  # [D, P]
    k_fc2: torch.Tensor,  # [P, P]
    w1m: torch.Tensor,  # [P + H, 4H]   rows: [w1_p; wh1]
    w2m: torch.Tensor,  # [P + 2H, 4H]  rows: [w2_p; w2_h1; wh2]
    proj_kernel: torch.Tensor,  # [2H, D]
    proj_bias: torch.Tensor,  # [D]
    dropout_scale: float,
) -> torch.Tensor:
    """Run the AR decode; returns mel frames [B, L, D] (pre-postnet)."""
    args = (g1c, g2c, keep1, keep2, k_fc1, k_fc2, w1m, w2m, proj_kernel, proj_bias)
    B, L, H, P, D = _check(*args)
    if g1c.device.type == "cpu":
        return ar_decode_plain(*args, dropout_scale)
    if g1c.device.type != "cuda":
        raise ValueError(f"ar_decode: no kernel for device {g1c.device}")
    if H % 32 != 0 or H > 1024:
        raise ValueError(f"ar_decode kernel needs H % 32 == 0 and H <= 1024, got H={H}")
    out = torch.empty(B, L, D, dtype=torch.float32, device=g1c.device)
    lib = _build.load_library()
    ar_decode.launches += 1
    _build.check(
        lib.viettts_ar_decode(
            *(t.data_ptr() for t in args), out.data_ptr(),
            B, L, H, P, D, float(dropout_scale), _build.stream_ptr(g1c.device),
        ),
        "ar_decode",
    )
    return out


ar_decode.launches = 0
ar_decode.plain_calls = 0
