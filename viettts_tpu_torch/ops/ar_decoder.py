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

The kernel is one persistent launch over a grid of co-resident CTAs, each
holding the float32 gate columns of its hidden units in shared memory for
the whole decode; ``plan_decode`` sizes that grid (the wrapper and the CPU
tests both call it) for the card's SM count and the launch's rows, and
refuses shapes whose slice does not fit.  The launch is cooperative and
capturable: inside a CUDA graph it becomes a cooperative kernel node,
after one launch of the same plan outside the capture has opted the kernel
in to its shared memory and checked its occupancy on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

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


THREADS = 256  # per CTA; csrc/ar_decoder.cu kThreads
STAGE_ROWS = 16  # batch rows staged at once, at most; kStage
BATCH_CHUNK = 8  # batch rows summed per matrix-vector pass; kChunk
MAX_ROWS = 64  # batch rows per launch; kRows (larger batches take several launches)
MAX_UNITS = 6  # hidden units per CTA the kernel is instantiated for; kMaxUnits
MAX_COLS = 2 * THREADS // 32  # prenet / projection columns of a CTA (2 per warp)
SMEM_LIMIT = 232_448  # dynamic shared memory a block can use on sm_90 (227 KB)


@dataclass(frozen=True)
class DecodePlan:
    ctas: int  # grid size, at most one CTA per SM
    units: int  # hidden units per CTA (all 4 gate columns of each, both layers); the last CTA may hold fewer
    prenet_cols: int  # prenet output columns per CTA (cta + i * ctas)
    proj_cols: int  # mel projection columns per CTA (cta + i * ctas)
    stage: int  # batch rows staged at once
    rows: int  # batch rows of the launch: its gate sums and cell states
    smem_bytes: int  # dynamic shared memory per CTA


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def smem_floats(H: int, P: int, D: int, U: int, PK: int, DK: int, S: int, R: int) -> int:
    """``smem_floats`` of ``csrc/ar_decoder.cu``: the floats of dynamic
    shared memory a CTA of the plan (U, PK, DK, S, R) uses."""
    nc, ncm = 4 * U, max(4 * U, PK, DK)
    return (
        _pad4(S * max(2 * H, P, D)) + THREADS // 32 * BATCH_CHUNK + _pad4(S * ncm)
        + R * 2 * nc + _pad4(R * 2 * U)
        + (2 * P + 3 * H) * nc + (D + P) * PK + (2 * H + 1) * DK
    )


@functools.lru_cache(maxsize=None)
def plan_decode(H: int, P: int, D: int, num_sms: int, rows: int = MAX_ROWS) -> DecodePlan:
    """Grid of the decode kernel for ``rows`` batch rows on ``num_sms`` SMs:
    the fewest hidden units per CTA that keeps the grid within ``num_sms``
    CTAs (the last CTA takes what is left), the prenet and projection
    columns spread the same way (powers of two), and the most staged rows
    (16, 8, 4, 2 or 1, one output per thread) whose shared memory, as
    ``smem_floats`` counts it, fits ``SMEM_LIMIT``.  Raises ValueError,
    naming the SM count, when no such plan exists."""
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"ar_decode kernel: {rows} rows per launch, want 1..{MAX_ROWS}")
    units = -(-H // num_sms)
    ctas = -(-H // units)
    prenet_cols, proj_cols = _pow2(-(-P // ctas)), _pow2(-(-D // ctas))
    ncm = max(4 * units, prenet_cols, proj_cols)
    smem = None
    for stage in sorted({min(s, rows) for s in (STAGE_ROWS, 8, 4, 2, 1)}, reverse=True):
        if stage * ncm > THREADS:
            continue
        smem = 4 * smem_floats(H, P, D, units, prenet_cols, proj_cols, stage, rows)
        if smem <= SMEM_LIMIT:
            break
    if smem is None or smem > SMEM_LIMIT:
        raise ValueError(
            f"ar_decode kernel: H={H}, P={P}, D={D} on {num_sms} SMs needs {smem} bytes of shared memory "
            f"per CTA ({ctas} CTAs of {units} hidden units, whose float32 gate columns of both LSTM layers "
            f"stay resident, {rows} rows), above the {SMEM_LIMIT} bytes a block can use"
        )
    if units > MAX_UNITS or max(prenet_cols, proj_cols) > MAX_COLS:
        raise ValueError(
            f"ar_decode kernel: H={H}, P={P}, D={D} on {num_sms} SMs needs {units} hidden units, "
            f"{prenet_cols} prenet and {proj_cols} projection columns per CTA; at most "
            f"{MAX_UNITS}, {MAX_COLS} and {MAX_COLS} fit its resident-weight layout"
        )
    return DecodePlan(ctas, units, prenet_cols, proj_cols, stage, rows, smem)


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


# (device index, H, P, D, plan) prepared in this process: the opt-in is the
# kernel's function attribute on that device, which lasts as long as the process
_prepared = set()


def _prepare(lib, device: torch.device, H: int, P: int, D: int, plan: DecodePlan) -> None:
    """Opt the kernel of ``plan`` in to its shared memory on ``device`` and
    check that its grid is co-resident, once per device and plan, never
    inside a stream capture (the first launch outside one prepares it)."""
    key = (device.index, H, P, D, plan)
    if key in _prepared:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"ar_decode: the plan {plan} was never launched on {device} outside a CUDA graph capture; "
            "launch it once eagerly before capturing"
        )
    _build.check(
        lib.viettts_ar_decode_prepare(H, P, D, plan.ctas, plan.units, plan.prenet_cols, plan.proj_cols,
                                      plan.stage, plan.rows, plan.smem_bytes),
        "ar_decode prepare",
    )
    _prepared.add(key)


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
    num_sms: Optional[int] = None,
) -> torch.Tensor:
    """Run the AR decode; returns mel frames [B, L, D] (pre-postnet).

    On CUDA the grid is planned for the card's SM count, or for
    ``num_sms`` when given (at most the card's: a smaller card's plan,
    still one co-resident cooperative launch).  Each launch zeroes its
    exchange buffer on the stream, so a CUDA graph that captures it starts
    every replay from frame tag 0."""
    args = (g1c, g2c, keep1, keep2, k_fc1, k_fc2, w1m, w2m, proj_kernel, proj_bias)
    B, L, H, P, D = _check(*args)
    if g1c.device.type == "cpu":
        return ar_decode_plain(*args, dropout_scale)
    if g1c.device.type != "cuda":
        raise ValueError(f"ar_decode: no kernel for device {g1c.device}")
    sms = torch.cuda.get_device_properties(g1c.device).multi_processor_count
    if num_sms is not None and not 1 <= num_sms <= sms:
        raise ValueError(f"ar_decode: num_sms={num_sms}, the card has {sms}")
    out = torch.empty(B, L, D, dtype=torch.float32, device=g1c.device)
    lib = _build.load_library()
    for b0 in range(0, B if L else 0, MAX_ROWS):
        rows = slice(b0, min(b0 + MAX_ROWS, B))
        n = rows.stop - b0
        plan = plan_decode(H, P, D, num_sms or sms, n)
        part = out if n == B else torch.empty(n, L, D, dtype=torch.float32, device=g1c.device)
        sliced = [t[rows] for t in args[:2]] + [t[:, rows].contiguous() for t in args[2:4]]
        with torch.cuda.device(g1c.device):
            _prepare(lib, g1c.device, H, P, D, plan)
            # exchange words (float | frame tag), two frame parities of
            # [h1 | h2, mel, p1, p]; zeroed: tag 0 is no frame
            exchange = torch.zeros(2 * 2 * n * (2 * H + D + 2 * P), dtype=torch.float32, device=g1c.device)
            ar_decode.launches += 1
            _build.check(
                lib.viettts_ar_decode(
                    *(t.data_ptr() for t in sliced + list(args[4:])), part.data_ptr(), exchange.data_ptr(),
                    n, L, H, P, D, plan.ctas, plan.units, plan.prenet_cols, plan.proj_cols,
                    plan.stage, plan.rows, plan.smem_bytes, float(dropout_scale), _build.stream_ptr(g1c.device),
                ),
                "ar_decode",
            )
        if part is not out:
            out[rows] = part
    return out


ar_decode.launches = 0
ar_decode.plain_calls = 0
