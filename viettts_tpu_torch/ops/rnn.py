"""LSTM primitives on tensors (counterpart of ``viettts_tpu/ops/rnn.py``).

The cell is haiku's: fused input/recurrent weights with gate order
(i, g, f, o) and a +1 bias on the forget gate, which ``nn.LSTM`` does not
have (it orders i, f, g, o and adds no constant).  Weights keep the JAX
layout, ``w_i [D, 4H]``, ``w_h [H, 4H]``, ``b [4H]``, so a checkpoint
loads without reordering.  The input projection ``x @ w_i + b`` for all
timesteps is one matmul hoisted out of the time loop.

``bidirectional_lstm`` runs the recurrence of both directions as one
launch of ``csrc/lstm.cu`` where nothing needs a gradient and the input
and weights are float32 CUDA tensors (the encoders at inference), and
otherwise ``bidirectional_lstm_plain``, the Python time loop over
``unroll_lstm`` (training, the CPU), which is also the kernel's twin.  On
CUDA with no gradient needed it raises for what the kernel does not run,
another dtype than float32 or a hidden size above ``MAX_H``, rather than
fall back to the loop.  ``bidirectional_lstm.launches`` counts kernel launches and
``bidirectional_lstm.plain_calls`` calls of the loop.  ``plan_lstm``
sizes the kernel's grid for the card's SM count (the wrapper and the CPU
tests both call it); it plans every hidden size up to ``MAX_H`` and
raises for a wider one.  The launch is cooperative and capturable, as
K1's (``ops/ar_decoder.py``): inside a CUDA graph it becomes a
cooperative kernel node, after one launch of the same plan outside the
capture has opted the kernel in to its shared memory and checked its
occupancy on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from viettts_tpu_torch.ops import _build


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


def bidirectional_lstm_plain(
    fwd_params, bwd_params, xs: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """The bi-LSTM as a Python time loop (the kernel's twin); see
    ``bidirectional_lstm``."""
    bidirectional_lstm.plain_calls += 1
    L = xs.shape[1]
    positions = torch.arange(L, device=xs.device)[None, :]
    reset = positions >= (lengths[:, None] - 1)
    h_fwd = unroll_lstm(fwd_params, xs)
    h_bwd = unroll_lstm(bwd_params, xs, reverse=True, reset_mask=reset)
    return torch.cat([h_fwd, h_bwd], dim=-1)


THREADS = 256  # per CTA; csrc/lstm.cu kThreads
UNITS = 16  # hidden units a CTA owns; kUnits
PASS_ROWS = 8  # batch rows staged and summed at once; kPass
PARTS = THREADS // (2 * UNITS)  # slices of w_h's rows a CTA sums apart; kParts
MAX_H = 512  # widest hidden size planned; kMaxH
MAX_ROWS = 64  # batch rows per launch; kRows (larger batches take several launches)


@dataclass(frozen=True)
class LstmPlan:
    ctas: int  # grid size: 2 directions x groups x slices, at most one CTA per SM
    slices: int  # CTAs of a (direction, row group), UNITS hidden units each; the last may be partly empty
    groups: int  # row groups a direction
    group_rows: int  # batch rows a group (the last may hold fewer)
    smem_bytes: int  # dynamic shared memory per CTA


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def lstm_smem_floats(H: int, group_rows: int) -> int:
    """``smem_floats`` of ``csrc/lstm.cu``: the w_h gate columns, the
    staged rows, the slices' partial sums, the cell states and the rows'
    first reset of a CTA."""
    return (H * 4 * UNITS + PASS_ROWS * _pad4(H) + PARTS * PASS_ROWS * 4 * UNITS + _pad4(group_rows * UNITS)
            + _pad4(group_rows))


def _check_width(H: int) -> None:
    if not 1 <= H <= MAX_H:
        raise ValueError(f"bidirectional_lstm kernel: H={H}; it plans hidden sizes 1..{MAX_H}")


@functools.lru_cache(maxsize=None)
def plan_lstm(H: int, rows: int, num_sms: int) -> LstmPlan:
    """Grid of the bi-LSTM kernel for ``rows`` batch rows on ``num_sms``
    SMs.  Each direction's hidden units split into slices of UNITS (the
    CTAs of a group, which exchange h every step); the rows split into as
    many groups as fit the SMs with both directions, at most one a row,
    each as even as it can be, so a CTA gathers and sums the fewest rows a
    step.  Raises ValueError for a hidden size above MAX_H or a card too
    small for one group of each direction."""
    _check_width(H)
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"bidirectional_lstm kernel: {rows} rows per launch, want 1..{MAX_ROWS}")
    slices = -(-H // UNITS)
    fit = num_sms // (2 * slices)
    if fit < 1:
        raise ValueError(
            f"bidirectional_lstm kernel: H={H} needs {2 * slices} co-resident CTAs, the card has {num_sms} SMs"
        )
    group_rows = -(-rows // min(rows, fit))
    groups = -(-rows // group_rows)
    return LstmPlan(2 * groups * slices, slices, groups, group_rows, 4 * lstm_smem_floats(H, group_rows))


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def kernel_engages(xs: torch.Tensor, *tensors: torch.Tensor) -> bool:
    """Whether ``bidirectional_lstm`` launches the kernel: the input and
    every weight are float32 CUDA tensors and no gradient is needed (grad
    mode off, or nothing requires one)."""
    every = (xs, *tensors)
    if any(t.device.type != "cuda" or t.dtype != torch.float32 for t in every):
        return False
    return not _needs_grad(every)


# (device index, H, plan) prepared in this process: the opt-in is the kernel's
# function attribute on that device, which lasts as long as the process
_prepared = set()


def _prepare(lib, device: torch.device, H: int, plan: LstmPlan) -> None:
    """Opt the kernel in to its shared memory on ``device`` and check that
    ``plan``'s grid is co-resident, once per device and plan, never inside
    a stream capture (the first launch outside one prepares it)."""
    key = (device.index, H, plan)
    if key in _prepared:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"bidirectional_lstm: the plan {plan} was never launched on {device} outside a CUDA graph "
            "capture; launch it once eagerly before capturing"
        )
    _build.check(
        lib.viettts_bilstm_prepare(H, plan.ctas, plan.slices, plan.groups, plan.group_rows, plan.smem_bytes),
        "bidirectional_lstm prepare",
    )
    _prepared.add(key)


def _bidirectional_lstm_kernel(fwd_params, bwd_params, xs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    B, T, D = xs.shape
    H = fwd_params.w_h.shape[0]
    for name, p in (("forward", fwd_params), ("backward", bwd_params)):
        shapes = ((p.w_i, (D, 4 * H)), (p.w_h, (H, 4 * H)), (p.b, (4 * H,)))
        if any(tuple(t.shape) != s for t, s in shapes) or any(t.device != xs.device for t, _ in shapes):
            raise ValueError(f"bidirectional_lstm: the {name} weights do not fit x {tuple(xs.shape)} on {xs.device}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"bidirectional_lstm: lengths has shape {tuple(lengths.shape)}, want ({B},)")
    _check_width(H)  # before any work: a width the kernel does not plan never falls back to the loop
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    out = torch.empty(B, T, 2 * H, dtype=torch.float32, device=xs.device)
    if B == 0 or T == 0:
        return out
    x2 = xs.reshape(B * T, D)
    # the hoisted input projections, x @ w_i + b, one matmul a direction
    xp = [torch.addmm(p.b, x2, p.w_i).view(B, T, 4 * H) for p in (fwd_params, bwd_params)]
    w_h = [p.w_h.contiguous() for p in (fwd_params, bwd_params)]
    lengths = lengths.to(device=xs.device, dtype=torch.int64).contiguous()
    lib = _build.load_library()
    with torch.cuda.device(xs.device):
        for b0 in range(0, B, MAX_ROWS):
            n = min(MAX_ROWS, B - b0)
            plan = plan_lstm(H, n, sms)
            _prepare(lib, xs.device, H, plan)
            # words (float | step tag) of [direction][step parity][n][H]; zeroed: tag 0 is no step
            exchange = torch.zeros(2 * 2 * n * H, dtype=torch.int64, device=xs.device)
            bidirectional_lstm.launches += 1
            _build.check(
                lib.viettts_bilstm(
                    xp[0][b0].data_ptr(), xp[1][b0].data_ptr(), w_h[0].data_ptr(), w_h[1].data_ptr(),
                    lengths[b0].data_ptr(), out[b0].data_ptr(), exchange.data_ptr(), n, T, H, plan.ctas,
                    plan.slices, plan.groups, plan.group_rows, plan.smem_bytes, _build.stream_ptr(xs.device),
                ),
                "bidirectional_lstm",
            )
    return out


def bidirectional_lstm(
    fwd_params, bwd_params, xs: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Bi-LSTM over padded [B, L, D] -> [B, L, 2H].

    The backward direction resets at each sequence's true last token
    (positions >= length - 1), so every real position sees backward
    context from real tokens only; outputs past ``lengths`` are garbage.
    One launch of the kernel per MAX_ROWS rows where ``kernel_engages``,
    which raises for a hidden size it does not plan; the loop where a
    gradient is needed or the input is not on CUDA.  Raises ValueError for
    any other call on CUDA (another dtype than float32, weights elsewhere)."""
    weights = [t for p in (fwd_params, bwd_params) for t in (p.w_i, p.w_h, p.b)]
    if kernel_engages(xs, *weights):
        return _bidirectional_lstm_kernel(fwd_params, bwd_params, xs, lengths)
    if xs.device.type == "cuda" and not _needs_grad((xs, *weights)):
        got = sorted({f"{t.dtype} on {t.device}" for t in weights})
        raise ValueError(f"bidirectional_lstm kernel: x is {xs.dtype} on {xs.device}, the weights "
                         f"{', '.join(got)}; it runs float32 CUDA tensors only")
    return bidirectional_lstm_plain(fwd_params, bwd_params, xs, lengths)


bidirectional_lstm.launches = 0
bidirectional_lstm.plain_calls = 0
