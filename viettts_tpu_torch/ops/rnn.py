"""LSTM primitives on tensors (counterpart of ``viettts_tpu/ops/rnn.py``).

The cell is haiku's: fused input/recurrent weights with gate order
(i, g, f, o) and a +1 bias on the forget gate, which ``nn.LSTM`` does not
have (it orders i, f, g, o and adds no constant).  Weights keep the JAX
layout, ``w_i [D, 4H]``, ``w_h [H, 4H]``, ``b [4H]``, so a checkpoint
loads without reordering.  The input projection ``x @ w_i + b`` for all
timesteps is one matmul hoisted out of the time loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class LSTM(nn.Module):
    """Holds one LSTM's parameters in the JAX layout."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.w_i = nn.Parameter(torch.zeros(input_dim, 4 * hidden_dim))
        self.w_h = nn.Parameter(torch.zeros(hidden_dim, 4 * hidden_dim))
        self.b = nn.Parameter(torch.zeros(4 * hidden_dim))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init (haiku's ``hk.Linear`` on ``[x, h]``): the
        fused [D + H, 4H] weight truncated-normal at +-2 sigma with sigma =
        1/sqrt(D + H), zero bias."""
        w = torch.empty(self.w_i.shape[0] + self.w_h.shape[0], self.w_i.shape[1])
        std = w.shape[0] ** -0.5
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.w_i.copy_(w[: self.w_i.shape[0]])
        self.w_h.copy_(w[self.w_i.shape[0] :])
        self.b.zero_()


def apply_gates(
    gates: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """haiku gate math on [B, 4H] gates: returns (h, c)."""
    i, g, f, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def unroll_lstm(
    params,
    xs: torch.Tensor,
    *,
    reverse: bool = False,
    reset_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run an LSTM over [B, L, D] -> [B, L, H] from a zero state.

    ``reverse=True`` scans from the last timestep to the first (the output
    stays time-aligned).  ``reset_mask`` [B, L] bool zeroes the state
    *before* consuming a step where it is set (haiku's ``ResetCore``).
    """
    B, L, _ = xs.shape
    H = params.w_h.shape[0]
    # [B, H] frames by unbind: the backward of L selects would zero-fill
    # and sum L full-size gradients
    x_proj = (xs @ params.w_i + params.b).unbind(1)
    h = xs.new_zeros(B, H)
    c = xs.new_zeros(B, H)
    hs = [None] * L
    for t in reversed(range(L)) if reverse else range(L):
        if reset_mask is not None:
            keep = (~reset_mask[:, t]).unsqueeze(-1).to(xs.dtype)
            h, c = h * keep, c * keep
        h, c = apply_gates(x_proj[t] + h @ params.w_h, c)
        hs[t] = h
    return torch.stack(hs, dim=1)


def bidirectional_lstm(
    fwd_params, bwd_params, xs: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Bi-LSTM over padded [B, L, D] -> [B, L, 2H].

    The backward direction resets at each sequence's true last token
    (positions >= length - 1), so every real position sees backward
    context from real tokens only; outputs past ``lengths`` are garbage.
    """
    L = xs.shape[1]
    positions = torch.arange(L, device=xs.device)[None, :]
    reset = positions >= (lengths[:, None] - 1)
    h_fwd = unroll_lstm(fwd_params, xs)
    h_bwd = unroll_lstm(bwd_params, xs, reverse=True, reset_mask=reset)
    return torch.cat([h_fwd, h_bwd], dim=-1)
