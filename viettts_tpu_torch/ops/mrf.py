"""One HiFi-GAN generator stage: CUDA kernels K2 and K3 and their plain twin.

Counterpart of ``viettts_tpu/ops/mrf.py::fused_mrf``.  A stage is

* an optional prologue: leaky_relu(0.1), then ConvTranspose1d (stride u,
  JAX "SAME" padding);
* the multi-receptive-field (MRF) stack: for each resblock and dilation d,
  ``x += conv_k,1(lrelu(conv_k,d(lrelu(x))))`` (ResBlock1) or
  ``x += conv_k,d(lrelu(x))`` (ResBlock2), the resblock outputs averaged;
* an optional epilogue: leaky_relu(0.01), conv_post, tanh.

Every conv zero-pads at the true sequence edges ("SAME").  Weights keep the
JAX (W, I, O) layout: ``weights[blk] = (W1 [D,k,C,C], B1 [D,C], W2, B2)``
with ``W2 = B2 = None`` for ResBlock2, ``upsample = (w [k,C_in,C], b [C],
u)`` and ``post = (w [kp,C,C_post], b [C_post])``.  ``compute_dtype``
selects the storage dtype of the weights and of the stage input and output
(float32 or bfloat16); biases are float32 and all arithmetic is float32,
as in the TPU kernel.  ``prepare_mrf_weights`` casts a float32 weight set
to that layout once; on the float32 route W1/W2 become ``Tf32Conv``, the
float32 weights with their TF32 hi/lo split (``tf32_split``), which the
kernel's 3xTF32 tensor-core dots read.  On the bf16 route the kernel's
dots take bf16(lrelu(x)) operands, as the TPU kernel's DEFAULT-precision
dots did; ``fused_mrf_plain(bf16_dots=True)`` rounds the same way.

``quantize_int8=True`` runs the 18 MRF convs as int8 x int8 -> int32 dots
(kernel K3, the TPU kernel's ``quantize_int8`` mode): W1/W2 are
``Int8Conv`` codes with per-output-channel scales, quantized once from the
float32 weights by ``prepare_mrf_weights(quantize_int8=True)``, which also
lays the codes out K-major for the kernel's int8 tensor-core dots; the
epilogue, biases, residuals and the block mean stay as on the float route,
and the prologue sums in float64 (rounded once to float32; the kernel's on
the FP64 tensor cores, from the ``F64Conv`` weights), so that the kernel
and the twin give its output the same int8 codes.  Each conv's
input ``lrelu(x)`` is quantized with one scale: ``act_scales`` [n_convs]
(calibrated amaxes in flat conv order, ``mrf_walk``) clips at a fixed
scale; without it the scale is dynamic, the amax of the conv input over
one of the TPU kernel's tile windows: a tile of its geometry
(``jax_tile_geometry``: at most 8192 packed rows of 128 lanes, fewer where
they do not divide the sequence) and a halo on each side, trimmed to the
sequence.  The stage's MRF and conv_post run on each window of the
stage trunk as a batch row of its own (``dynamic_windows``, ``by_windows``),
and each window's tile is kept: one tile is one amax a batch row.

``fused_mrf`` runs ``csrc/mrf.cu`` (and ``csrc/mrf_int8.cu``,
``csrc/mrf_tf32.cu``) on CUDA tensors and ``fused_mrf_plain`` on CPU
tensors; any other device raises.  On CUDA the MRF convs take one of three
pipelines, by the plan alone:

* the fused pipeline (``csrc/mrf_fused.cuh``) on the bf16 and static
  int8 routes at the widths of ``FUSED_CHANNELS``: a launch runs whole
  resblocks for time tiles on chip (``plan_fused``; ``fused_mrf_tiled`` is
  its schedule in plain PyTorch, for the tests);
* the per-conv wgmma pipeline (``csrc/mrf_conv_wgmma.cuh``) for the stages
  its plan takes on each of its routes (``csrc/mrf_conv_plan.h``, asked
  through ``conv_takes``; ``conv_route``: bf16, static int8, tf32 for the
  float32 route's 3xTF32, dynamic int8): one launch a conv, each epilogue
  writing the next conv's operand (chunk-major, ``pack_operand``: bf16,
  int8 codes, or the TF32 parts hi and lo) or, with dynamic scales,
  float32 and its amax (a quantize pass writes the codes); float32 only for
  the residual trunk and the resblocks' sum; the weights come in their
  slot layout (``Bf16Conv.slots``, ``Int8Conv.slots``, ``Tf32Conv.slots``:
  ``conv_slots``, ``tf32_slots``); ``mrf_conv_stage_plain`` is that
  storage in plain PyTorch, for the tests;
* the per-conv ``mma_conv_kernel`` pipeline (one launch plan of 18 convs a
  stage) at the widths and shapes neither of the others takes.
``fused_mrf.launches`` counts stages that launched K2 kernels (on the int8
route: the epilogue or a bf16 input's cast), ``fused_mrf.int8_launches``
stages that launched K3 (the int8 MRF convs and the float64 prologue),
``fused_mrf.conv_launches``, ``tf32_conv_launches``,
``int8_conv_launches`` and ``int8_dynamic_conv_launches`` the stages
among them whose MRF convs ran on the per-conv wgmma pipeline on its bf16,
tf32, static and dynamic int8 routes, and ``fused_mrf.plain_calls`` calls
of the twin.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from viettts_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
POST_LRELU_SLOPE = 0.01  # torch's default slope, as upstream HiFi-GAN uses
MAX_POST_CHANNELS = 4  # the epilogue kernel keeps one accumulator per channel
PLAN_FIELDS = 13  # int64 fields of a conv in a launch plan (csrc/mrf_common.cuh)

# The fused resblock pipeline (csrc/mrf_fused.cuh): its launch constants
# and shared-memory formula, which tests/test_torch_mrf_fused.py holds to
# the source; ``plan_fused`` plans a stage and the C side checks the plan.
# It takes the bf16 and static int8 stages of these widths, where it beat
# the per-conv pipeline on the H100 at B=1 (512 mel frames), B=2 (128) and
# B=64 (768) alike; at C = 128 it did not, and the float32 route lost at
# every width (PERF.md §6).
FUSED_CHANNELS = (32, 64)
FUSED_BOX = 256  # rows of a TMA box: a wider window takes two of half its rows
FUSED_BLOCK = 64  # rows of a wgmma block; a tile has at least this many
FUSED_MAX_BLOCKS = 8  # blocks a conv's range may span: windows of up to 512 rows
FUSED_MAX_RES = 4
FUSED_MAX_UNITS = 4
FUSED_RES_FIELDS = 13  # int64 fields of a resblock in a launch's table
FUSED_MIN_STAGES, FUSED_MAX_STAGES = 2, 4  # ring slots the kernel takes
FUSED_SLOT_BYTES = 16384  # weight bytes a ring slot holds at most (as many taps as fit)
FUSED_TRAITS = {"bf16": (2, 2), "int8": (1, 1)}  # route: (row-buffer element bytes, weight element bytes)
FUSED_RING = (3, 2)  # ring depths the plan tries
SMEM_LIMIT = 232_448  # shared memory a block may opt in to on the H100

# The per-conv wgmma pipeline (csrc/mrf_conv_wgmma.cuh) reads its operands
# and weights in K chunks of at most this many bytes a row (64 bf16, 128
# int8 or 16 TF32 input channels, or C's own 32 or 64 bytes of int8), in
# 16-byte planes: the layout of ``conv_slots``, ``tf32_slots`` and
# ``pack_operand``.  Which stages it takes, and each conv's tiles, are the
# C plan's (csrc/mrf_conv_plan.h: ``conv_takes``, ``conv_plan``).
CONV_CHUNK_BYTES = 128
CONV_ROUTES = {"bf16": 0, "int8": 1, "tf32": 2, "int8_dynamic": 3}  # the plan's route codes
# True: the router (``conv_takes``); False sends every stage to
# mma_conv_kernel and "any" every stage the C plan tiles to the wgmma
# pipeline (for timing the two in turns, whatever the router says).
CONV_WGMMA = True


class Tf32Conv(NamedTuple):
    """A resblock's stacked float32 convs for the kernels' 3xTF32 dots:
    ``w`` float32 [D, k, C_in, C_out] (what the twin reads), ``split``
    float32 [D, 2, k, C_out, C_in], its TF32 parts hi and lo in
    ``mma_conv_kernel``'s layout (``tf32_split``), and ``slots``, the same
    parts in the per-conv wgmma pipeline's (``tf32_slots``; None where 16
    does not divide C_in)."""

    w: torch.Tensor
    split: torch.Tensor
    slots: Optional[torch.Tensor] = None


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, the low 13 bits cleared: PTX ``cvt.rna.tf32.f32``."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: torch.Tensor) -> torch.Tensor:
    """Stacked (W, I, O) weights [D, k, C_in, C_out] -> the kernel's 3xTF32
    layout [D, 2, k, C_out, C_in]: ``hi = tf32(w)`` and ``lo = tf32(w - hi)``
    (``hi + lo`` keeps 22 of w's 24 significant bits), each tap transposed
    to (O, I) so that a row of the weight tile is contiguous in C_in."""
    return torch.stack(tf32_parts(w), dim=1).transpose(-1, -2).contiguous()


def tf32_parts(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 y as its TF32 parts ``hi = tf32(y)``, ``lo = tf32(y - hi)``,
    as the kernels split operands (``cvt.rna.tf32.f32``)."""
    hi = tf32_round(y)
    return hi, tf32_round(y - hi)


class Bf16Conv(NamedTuple):
    """A resblock's stacked bf16 convs: ``w`` [D, k, C_in, C_out] (what
    the twin and ``mma_conv_kernel`` read) and ``slots``, the same weights
    in the per-conv wgmma pipeline's layout (``conv_slots``), or None
    where C_in is not a whole number of its chunks."""

    w: torch.Tensor
    slots: Optional[torch.Tensor] = None


class F64Conv(NamedTuple):
    """The int8 route's ConvTranspose weight: ``w`` [k, C_in, C_out] in the
    storage dtype (what the twin reads) and ``kmajor`` float64 [k, C_out,
    C_in], ``w`` converted exactly and transposed for the kernel's float64
    tensor-core dots (whose B tile rows must be contiguous in C_in)."""

    w: torch.Tensor
    kmajor: torch.Tensor


def _dense(w):
    """The float weight tensor of an entry (a tensor, a ``Tf32Conv``, a
    ``Bf16Conv`` or an ``F64Conv``)."""
    return w.w if isinstance(w, (Tf32Conv, Bf16Conv, F64Conv)) else w


class Int8Conv(NamedTuple):
    """A resblock's stacked convs quantized to int8: ``codes`` int8
    [D, k, C_in, C_out] and per-output-channel ``scales`` float32 [D, C_out],
    so that ``w ~= codes * scales``; ``kmajor`` int8 [D, k, C_out, C_in],
    the codes in the layout of the kernel's int8 dots (``ldmatrix`` cannot
    transpose 8-bit elements, so the B tile rows must be contiguous in
    C_in); ``slots``, the codes in the per-conv wgmma pipeline's layout
    (``conv_slots``; None where C_in is not a whole number of its chunks).
    The twin reads ``codes``; the kernels need ``kmajor`` and ``slots``."""

    codes: torch.Tensor
    scales: torch.Tensor
    kmajor: Optional[torch.Tensor] = None
    slots: Optional[torch.Tensor] = None


def conv_chunk(c_in: int, channel_bytes: int) -> Optional[int]:
    """Input channels of the per-conv wgmma pipeline's K chunk for C_in
    channels of ``channel_bytes`` each: ``CONV_CHUNK_BYTES`` of them, or
    C_in's own 32 or 64 bytes where it is narrower (csrc/mrf_conv_plan.h::
    conv_chunk_planes); None where no chunk divides C_in."""
    row = c_in * channel_bytes
    chunk = min(row, CONV_CHUNK_BYTES)
    if chunk not in (32, 64, 128) or row % chunk:
        return None
    return chunk // channel_bytes


def conv_slots(w: torch.Tensor) -> Optional[torch.Tensor]:
    """Stacked bf16 weights or int8 codes [D, k, C_in, C_out] in the per-conv
    wgmma pipeline's layout, [D, C_in / KC, k, KC / e, C_out, e]: for each
    (input chunk of KC channels, ``conv_chunk``, tap) one weight slot of KC
    / e planes, each C_out rows of e inputs (16 bytes), the K-major B
    operand a bulk copy lands as; None where no chunk divides C_in."""
    D, k, c_in, c_out = w.shape
    e, kc = 16 // w.element_size(), conv_chunk(c_in, w.element_size())
    if kc is None:
        return None
    return w.reshape(D, k, c_in // kc, kc // e, e, c_out).permute(0, 2, 1, 3, 5, 4).contiguous()


def tf32_slots(w: torch.Tensor) -> Optional[torch.Tensor]:
    """Stacked float32 weights [D, k, C_in, C_out] as the per-conv wgmma
    pipeline's 3xTF32 slots, [D, C_in / 16, k, 8, C_out, 4]: for each
    (chunk of 16 inputs, tap) 4 planes of ``hi = tf32(w)`` then 4 of ``lo =
    tf32(w - hi)`` (``tf32_split``'s parts), each C_out rows of 4 inputs;
    None where 16 does not divide C_in."""
    D, k, c_in, c_out = w.shape
    if c_in % 16:
        return None
    parts = torch.stack(tf32_parts(w.float()), dim=2)  # [D, k, 2, C_in, C_out]
    slots = parts.reshape(D, k, 2, c_in // 16, 4, 4, c_out).permute(0, 3, 1, 2, 4, 6, 5)
    return slots.reshape(D, c_in // 16, k, 8, c_out, 4).contiguous()


def quantize_weight_int8(w: torch.Tensor) -> Int8Conv:
    """Symmetric per-output-channel int8 of float32 conv weights [..., k,
    C_in, C_out]: ``s = max(max|w[..., o]|, 1e-12) / 127`` over taps and
    inputs, codes ``clip(round(w / s), -127, 127)`` (round half to even),
    as the TPU kernel quantizes each packed column (``mrf.py:576-580``)."""
    if w.dtype != torch.float32:
        raise ValueError(f"quantize_weight_int8: quantize from float32 weights, got {w.dtype}")
    s = torch.clamp_min(w.abs().amax(dim=(-3, -2)), 1e-12) / _f32(127.0, w)
    codes = torch.clamp(torch.round(w / s[..., None, None, :]), -127.0, 127.0).to(torch.int8)
    slots = conv_slots(codes) if codes.dim() == 4 else None
    return Int8Conv(codes.contiguous(), s.contiguous(), codes.transpose(-1, -2).contiguous(), slots)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor on ``like``'s device.  Dividing by it (or
    into it) is IEEE division; with a Python number, torch computes
    ``v / t`` as ``reciprocal(t) * v``, and on CUDA ``t / v`` as
    ``t * (1 / v)``: one more rounding than the TPU kernel's division."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def storage_dtype(compute_dtype) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def n_convs(weights) -> int:
    """Number of MRF convs in a stage: the length of its ``act_scales``."""
    return sum(b1.shape[0] * (1 if w2 is None else 2) for _, b1, w2, _ in weights)


def convt_lead_pad(k: int, u: int) -> int:
    """Leading pad of JAX's SAME ``conv_transpose`` (lax._conv_transpose_padding):
    input row i reaches output n = i*u + pad_a - t through tap t."""
    return k - 1 if u > k - 1 else -(-(k + u - 2) // 2)


def conv_transpose_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, u: int
) -> torch.Tensor:
    """JAX-SAME ConvTranspose1d on [B, C_in, L] with a torch-layout weight
    [C_in, C_out, k] -> [B, C_out, L*u]."""
    k = w.shape[-1]
    n = x.shape[-1] * u
    y = F.conv_transpose1d(x, w, stride=u)  # full output, length (L-1)*u + k
    start = k - 1 - convt_lead_pad(k, u)
    y = F.pad(y, (0, max(0, start + n - y.shape[-1])))[..., start : start + n]
    return y + b[None, :, None]


def convt_weight_to_torch(w: torch.Tensor) -> torch.Tensor:
    """JAX ConvTranspose kernel (W, I, O) -> torch (I, O, W): torch applies
    the taps mirrored relative to ``lax.conv_transpose``."""
    return w.flip(0).permute(1, 2, 0)


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """SAME conv on [B, C, L] with a JAX-layout weight (W, I, O)."""
    k = w.shape[0]
    return F.conv1d(
        x, w.float().permute(2, 1, 0), b.float(),
        padding=d * (k - 1) // 2, dilation=d,
    )


def _conv_int8(
    x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, b: torch.Tensor,
    d: int, act: Optional[torch.Tensor], same: bool = True,
) -> torch.Tensor:
    """One quantized SAME conv (``same=False``: unpadded) on the float32
    conv input x [B, C, L], in the TPU kernel's order of float32
    operations (``mrf.py:280-357``).
    ``act`` is the calibrated amax (static; inputs beyond it clip) or None
    (dynamic: the amax of each batch row, no clip).  The integer dot runs
    as a float64 conv of the codes, which is exact: its sums stay far below
    2**53, where float32 would round above 2**24."""
    c127 = _f32(127.0, x)
    if act is not None:
        a = torch.clamp_min(act, 1e-12)
        q = torch.round(torch.clamp(x * (c127 / a), -127.0, 127.0))
        mult = (scales * (a / c127))[None, :, None]
    else:
        a = x.abs().amax(dim=(1, 2))  # [B]
        q = torch.round(x * (c127 / torch.clamp_min(a, 1e-30))[:, None, None])
        mult = ((a * (1.0 / 127.0))[:, None] * scales[None, :])[..., None]
    k = codes.shape[0]
    dot = F.conv1d(
        q.double(), codes.double().permute(2, 1, 0),
        padding=d * (k - 1) // 2 if same else 0, dilation=d,
    )
    return dot.float() * mult + b[None, :, None]


def _mrf_stack(h, weights, kernel_sizes, dilations, conv: Callable[..., torch.Tensor]) -> torch.Tensor:
    """The MRF resblocks on the stage trunk h [B, C, L]: ``conv(inp, w, b,
    j, d, index)`` applies conv j of a stacked weight to its lrelu'd input;
    ``index`` counts the stage's convs in the flat order of ``act_scales``
    (resblocks, dilation units, then the unit's one or two convs)."""
    index = 0
    acc = None
    for blk in range(len(kernel_sizes)):
        w1, b1, w2, b2 = weights[blk]
        r = h
        for j, d in enumerate(dilations[blk]):
            y = conv(F.leaky_relu(r, LRELU_SLOPE), w1, b1, j, d, index)
            index += 1
            if w2 is not None:
                y = conv(F.leaky_relu(y, LRELU_SLOPE), w2, b2, j, 1, index)
                index += 1
            r = y + r
        acc = r if acc is None else acc + r
    return acc / _f32(len(kernel_sizes), acc)


def mrf_walk(
    x: torch.Tensor,
    weights: Sequence[Tuple],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    metric: Callable[[int, torch.Tensor], torch.Tensor],
    *,
    upsample: Optional[Tuple] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One stage in plain float32 on x [B, C_in, L_in] (channels first),
    with float weights: returns the MRF output [B, C, L] and
    ``metric(index, conv_input)`` for every MRF conv in flat conv order —
    what int8 calibration (amax) and the clip probe (clip fraction) read."""
    h = x.float()
    if upsample is not None:
        w_t, b_t, u = upsample
        h = conv_transpose_same(
            F.leaky_relu(h, LRELU_SLOPE), convt_weight_to_torch(_dense(w_t).float()), b_t.float(), u
        )
    vals: List[torch.Tensor] = []

    def conv(inp, w, b, j, d, index):
        vals.append(metric(index, inp))
        return _conv_same(inp, _dense(w)[j], b[j], d)

    return _mrf_stack(h, weights, kernel_sizes, dilations, conv), vals


# ---------------------------------------------------------------------------
# The TPU kernel's tile geometry (viettts_tpu/ops/mrf.py), copied: the
# dynamic int8 scale spans one of its tile windows, and where it cannot tile
# a stage, JAX's generator falls back to other programs.
# ---------------------------------------------------------------------------

LANES = 128  # the TPU kernel packs g = 128 / C steps of C < 128 channels into a row
RESIDENT_BUDGET = 10 * 1024 * 1024  # fused_mrf's resident_budget default
STREAMED_TILE_BYTES = 6 * 1024 * 1024  # the tile budget of a kernel that streams its weights
TILE_MB_DEFAULT = "48"  # VIETTTS_MRF_TILE_MB, the tile budget of a weight-resident kernel


def pack_offsets(k: int, d: int, g: int) -> List[int]:
    """The packed-row offsets q of a conv (kernel k, dilation d) on rows of
    g steps: output block j of row m reads row m + q (``_pack_offsets``)."""
    c = (k - 1) // 2
    return sorted({(j + (t - c) * d) // g for j in range(g) for t in range(k)})


def conv_radius_rows(k: int, d: int, g: int) -> int:
    """A conv's reach in packed rows (``_conv_radius_rows``)."""
    offsets = pack_offsets(k, d, g)
    return max(-offsets[0], offsets[-1])


def stack_radius_rows(kernel_sizes, dilations, g: int, two_convs: bool = True) -> int:
    """The worst reach in packed rows of one resblock's conv chain
    (``_stack_radius_rows``; ``two_convs=False``: ResBlock2)."""
    r = 0
    for k, dils in zip(kernel_sizes, dilations):
        blk = 0
        for d in dils:
            blk += conv_radius_rows(k, d, g) + (conv_radius_rows(k, 1, g) if two_convs else 0)
        r = max(r, blk)
    return r


def pick_tile_rows(rows: int, width: int, budget_bytes: int = STREAMED_TILE_BYTES) -> int:
    """Tile rows so that ~8 float32 [tile, width] buffers fit the budget: a
    power of two from 256 to 8192 that divides ``rows``, or ``rows``
    itself (``_pick_tile_rows``)."""
    budget = budget_bytes // (8 * width * 4)
    t = 1 << (max(budget, 256).bit_length() - 1)
    t = min(t, 8192, rows)
    while t > 1 and rows % t != 0:
        t //= 2
    return t


class TileGeometry(NamedTuple):
    """One ``fused_mrf`` call of the TPU kernel: ``tile`` and ``halo`` in
    steps (its Tp and Hp packed rows times g; None where it cannot pack the
    stage), and ``error``, the ValueError text that the call raises, or
    None where it runs."""

    tile: Optional[int]
    halo: Optional[int]
    error: Optional[str]


@functools.lru_cache(maxsize=1024)
def _tile_geometry(L_in, C_in, C, kernel_sizes, dilations, resblock2, upsample, post_k, io_bytes, weight_bytes,
                   tile_mb):
    L = L_in * (upsample[1] if upsample else 1)
    g = max(1, LANES // C)
    if C < LANES and LANES % C != 0:
        return TileGeometry(None, None, f"channels {C} must divide {LANES}")
    if C >= LANES and C % LANES != 0:
        return TileGeometry(None, None, f"channels {C} must be a multiple of {LANES}")
    W = g * C
    if L % g != 0:
        return TileGeometry(None, None, f"length {L} not divisible by packing {g}")
    rows = L // g
    align = 8 * (4 // io_bytes)
    radius = stack_radius_rows(kernel_sizes, dilations, g, not resblock2)
    if post_k is not None:
        radius += conv_radius_rows(post_k, 1, g)
    Hp = -(-radius // align) * align
    n_offsets = sum(len(pack_offsets(k, dc, g))
                    for k, dils in zip(kernel_sizes, dilations) for d in dils
                    for dc in ((d,) if resblock2 else (d, 1)))
    resident = n_offsets * W * W * weight_bytes <= RESIDENT_BUDGET
    Tp = pick_tile_rows(rows, W, tile_mb * 1024 * 1024 if resident else STREAMED_TILE_BYTES)

    def geometry(error=None):
        return TileGeometry(Tp * g, Hp * g, error)

    if Tp % align != 0:
        return geometry(f"tile {Tp} not {align}-row aligned")
    if upsample is not None:
        u = upsample[1]
        g_in = max(1, LANES // C_in)
        if C_in < LANES and LANES % C_in != 0:
            return geometry(f"in-channels {C_in} must divide {LANES}")
        if C_in >= LANES and C_in % LANES != 0:
            return geometry(f"in-channels {C_in} must be a multiple of {LANES}")
        if L_in % g_in != 0:
            return geometry(f"input length {L_in} not divisible by {g_in}")
        if (g_in * u) % g != 0:  # an assertion in JAX (_pack_transpose_matrices), not a ValueError
            return geometry(f"packing {g_in} x stride {u} not divisible by {g}")
        F_rows = (g_in * u) // g
        if Hp % F_rows != 0 or Tp % F_rows != 0:
            return geometry(f"tile ({Tp}) / halo ({Hp}) not divisible by {F_rows}")
    return geometry()


def jax_tile_geometry(
    L_in: int, C_in: int, C: int, kernel_sizes, dilations, resblock2: bool, *,
    upsample: Optional[Tuple[int, int]] = None, post_k: Optional[int] = None,
    store=torch.float32, quantize_int8: bool = False,
) -> TileGeometry:
    """The tile geometry of the TPU kernel's ``fused_mrf`` call
    (``viettts_tpu/ops/mrf.py::fused_mrf``, its checks in their order) on
    an input of L_in steps and C_in channels (the stage's C without a
    prologue), with ``upsample`` (kernel size, stride) and a conv_post of
    ``post_k`` taps, storage ``store`` (the halo and tile align to 16 rows
    for bfloat16, 8 for float32) and int8 or float weights (their bytes
    decide whether the kernel keeps them resident, which lets its tile grow
    to ``VIETTTS_MRF_TILE_MB``, 48 MB by default, read as JAX reads it).
    Plain Python: no card needed."""
    io_bytes = 2 if store == torch.bfloat16 else 4
    return _tile_geometry(
        int(L_in), int(C_in), int(C), tuple(kernel_sizes), tuple(tuple(d) for d in dilations), bool(resblock2),
        None if upsample is None else (int(upsample[0]), int(upsample[1])), post_k, io_bytes,
        1 if quantize_int8 else io_bytes, int(os.environ.get("VIETTTS_MRF_TILE_MB", TILE_MB_DEFAULT)),
    )


@functools.lru_cache(maxsize=1024)
def tile_windows(L: int, tile: int, halo: int) -> Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]:
    """The TPU kernel's tile windows on a sequence of L steps, trimmed to
    [0, L): window t spans [max(0, t·tile − halo), min(L, (t+1)·tile +
    halo)), which holds what its buffer holds there (its rows outside the
    sequence are zero after every conv, as SAME padding is).  Grouped by
    length: [(length, [(start, t), ...])]."""
    groups: dict = {}
    for t in range(L // tile):
        start, end = max(0, t * tile - halo), min(L, (t + 1) * tile + halo)
        groups.setdefault(end - start, []).append((start, t))
    return tuple((n, tuple(items)) for n, items in sorted(groups.items()))


class TileRun(NamedTuple):
    """A dynamic stage's tile windows: ``n`` a batch row of ``B``, each
    ``length = tile + 2 * halo`` steps from ``w * tile - halo`` of a
    sequence of ``seq`` steps, the steps outside it zero, as in the TPU
    kernel's buffer.  On the card they run as one batch (run row w * B +
    b is window w of batch row b); the twin trims them to the sequence
    (``tile_windows``, ``by_windows``)."""

    n: int
    B: int
    tile: int
    halo: int
    seq: int
    length: int


def dynamic_windows(x, weights, kernel_sizes, dilations, upsample=None, post=None,
                    store=torch.float32) -> Optional[TileRun]:
    """The tile windows of a dynamic int8 ``fused_mrf`` call, or None where
    the stage is one window: one tile, or a width the TPU kernel cannot
    pack (its generator then leaves the stage unquantized:
    ``models/hifigan.py``)."""
    k_u, u = (_dense(upsample[0]).shape[0], upsample[2]) if upsample is not None else (None, 1)
    C = x.shape[2] if upsample is None else _dense(upsample[0]).shape[2]
    geo = jax_tile_geometry(x.shape[1], x.shape[2], C, kernel_sizes, dilations, weights[0][2] is None,
                            upsample=None if upsample is None else (k_u, u),
                            post_k=None if post is None else post[0].shape[0], store=store, quantize_int8=True)
    L = x.shape[1] * u
    if geo.tile is None or geo.tile >= L:
        return None
    return TileRun(L // geo.tile, x.shape[0], geo.tile, geo.halo, L, geo.tile + 2 * geo.halo)


def gather_windows(h: torch.Tensor, items: Sequence[Tuple[int, int]], length: int) -> torch.Tensor:
    """Windows of ``length`` steps of h [B, L, C] starting at each item's
    start, as batch rows window-major: [len(items) * B, length, C], one copy
    where the starts are evenly spaced."""
    B, L, C = h.shape
    starts = [s for s, _ in items]
    step = starts[1] - starts[0] if len(starts) > 1 else L
    if all(b - a == step for a, b in zip(starts, starts[1:])):
        view = h.as_strided((len(starts), B, length, C), (step * C, L * C, C, 1),
                            h.storage_offset() + starts[0] * C)
        return view.reshape(len(starts) * B, length, C).contiguous()  # B = 1: a view until here
    return torch.cat([h[:, s:s + length] for s in starts])


def scatter_centres(y: torch.Tensor, items: Sequence[Tuple[int, int]], tile: int, out: torch.Tensor) -> None:
    """Each window's tile (its steps [t·tile, (t+1)·tile)) from y
    [len(items) * B, length, C_out] into out [B, L, C_out], one copy where
    the tiles are consecutive and sit at one offset in their windows."""
    n, B = len(items), out.shape[0]
    y = y.view(n, B, y.shape[1], y.shape[2])
    offs = [t * tile - s for s, t in items]
    ts = [t for _, t in items]
    if all(o == offs[0] for o in offs) and ts == list(range(ts[0], ts[0] + n)):
        tiles = out.view(B, out.shape[1] // tile, tile, out.shape[2])
        tiles[:, ts[0]:ts[0] + n].copy_(y[:, :, offs[0]:offs[0] + tile].transpose(0, 1))
        return
    for i, (o, t) in enumerate(zip(offs, ts)):
        out[:, t * tile:(t + 1) * tile].copy_(y[i, :, o:o + tile])


def by_windows(h: torch.Tensor, run: TileRun, stage: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Run ``stage`` (the MRF and any conv_post on a float32 trunk [B', L',
    C] -> [B', L', C_out]) on the tile windows ``run`` (``dynamic_windows``)
    of the trunk h [B, L, C], trimmed to the sequence, the windows of each
    length as the batch rows of one call, and put each window's tile in
    place: what the TPU kernel computes with one dynamic scale a tile
    window."""
    out = None
    for length, items in tile_windows(run.seq, run.tile, run.halo):
        y = stage(gather_windows(h, items, length))
        if out is None:
            out = torch.empty(h.shape[0], h.shape[1], y.shape[2], dtype=y.dtype, device=y.device)
        scatter_centres(y, items, run.tile, out)
    return out


# ---------------------------------------------------------------------------
# The fused pipeline's plan, and its tile schedule in plain PyTorch.
# ---------------------------------------------------------------------------


class FusedLaunch(NamedTuple):
    """The fused kernel's launch for a stage: its ``n_res`` resblocks on
    tiles of ``bm`` output rows in windows of ``win = bm + 2 * halo`` rows,
    ``tiles_per_row`` a batch row, by ``ctas`` persistent blocks with a
    weight ring of ``stages`` slots."""

    n_res: int
    halo: int
    win: int
    bm: int
    stages: int
    tiles_per_row: int
    ctas: int
    smem_bytes: int


def fused_halo(k: int, dils: Sequence[int], resblock2: bool) -> int:
    """Rows a resblock's convs reach on each side: (k-1)/2 per unit of
    dilation, (k-1)/2 * (d + 1) for a ResBlock1 unit's two convs."""
    return (k - 1) // 2 * sum(d if resblock2 else d + 1 for d in dils)


def fused_slot_bytes(route: str, C: int) -> int:
    """``fused_slot_bytes`` of csrc/mrf_fused.cuh: as many weight taps (C x
    C elements) as fit FUSED_SLOT_BYTES."""
    we = FUSED_TRAITS[route][1]
    return FUSED_SLOT_BYTES // (C * C * we) * (C * C * we)


def fused_smem_bytes(route: str, C: int, win: int, bm: int, stages: int) -> int:
    """``fused_smem_bytes`` of csrc/mrf_fused.cuh."""
    op = FUSED_TRAITS[route][0]
    return 256 + stages * fused_slot_bytes(route, C) + win * C * (4 + op) + bm * C * 4


def fused_windows() -> List[int]:
    """The window rows the kernel takes: multiples of 8 (128-byte aligned
    TMA destinations) up to one box, of 16 past it (two boxes of half the
    rows), up to FUSED_BLOCK * FUSED_MAX_BLOCKS."""
    return list(range(8, FUSED_BOX + 1, 8)) + list(range(FUSED_BOX + 16, FUSED_BLOCK * FUSED_MAX_BLOCKS + 1, 16))


def fused_block_rows(win: int, halo: int, k: int, dils: Sequence[int], resblock2: bool, block: int = FUSED_BLOCK) -> int:
    """Rows the fused kernel computes for one resblock in one tile of a
    ``win``-row window with the launch's ``halo``: each conv's output range
    (shrinking by its reach) in whole ``block``-row blocks."""
    lo = halo - fused_halo(k, dils, resblock2)
    hi, rows = win - lo, 0
    for d in dils:
        for dil in (d,) if resblock2 else (d, 1):
            lo, hi = lo + (k - 1) // 2 * dil, hi - (k - 1) // 2 * dil
            rows += -(-(hi - lo) // block) * block
    return rows


def plan_fused(
    route: str, C: int, kernel_sizes: Sequence[int], dilations: Sequence[Sequence[int]],
    resblock2: bool, B: int, L: int, sms: int,
) -> Optional[FusedLaunch]:
    """The fused kernel's launch for a stage of width C on ``route``
    (``bf16`` or ``int8`` with static scales), or None where it does not
    take the stage (C outside ``FUSED_CHANNELS``, or no tile fits a
    block's shared memory): those stages take the per-conv pipeline.  Of
    the (ring depth in ``FUSED_RING``, window) pairs that fit, it takes the
    one whose busiest block computes the fewest rows: tiles a block (the
    persistent grid's waves, ``B * tiles_per_row`` tiles over ``sms``
    blocks) times the rows a tile computes (``fused_block_rows``: the halo
    and the 64-row blocks); then the fewest rows per output row, the deeper
    ring, the wider window."""
    return _plan_fused(route, C, tuple(kernel_sizes), tuple(map(tuple, dilations)), resblock2, B, L, sms)


@functools.lru_cache(maxsize=512)
def _plan_fused(route, C, kernel_sizes, dilations, resblock2, B, L, sms):
    """``plan_fused`` on hashable arguments, once per shape: the search
    costs ~0.6 ms of host time, more than a small stage's kernel."""
    if (C not in FUSED_CHANNELS or route not in FUSED_TRAITS or len(kernel_sizes) > FUSED_MAX_RES
            or any(len(d) > FUSED_MAX_UNITS for d in dilations)):
        return None
    H = max(fused_halo(k, d, resblock2) for k, d in zip(kernel_sizes, dilations))
    fits = [(stages, w) for stages in FUSED_RING for w in fused_windows()
            if w - 2 * H >= FUSED_BLOCK and fused_smem_bytes(route, C, w, w - 2 * H, stages) <= SMEM_LIMIT]
    if not fits:
        return None

    def cost(pair):
        stages, w = pair
        rows = sum(fused_block_rows(w, H, k, d, resblock2) for k, d in zip(kernel_sizes, dilations))
        waves = -(-B * -(-L // (w - 2 * H)) // sms)
        return waves * rows, rows / (w - 2 * H), -stages, -w

    stages, win = min(fits, key=cost)
    bm = win - 2 * H
    tiles = -(-L // bm)
    return FusedLaunch(len(kernel_sizes), H, win, bm, stages, tiles, min(B * tiles, sms),
                       fused_smem_bytes(route, C, win, bm, stages))


def fused_route_name(route: str, int8_static: bool = False) -> Optional[str]:
    """The fused kernel's route for a serving route (``bfloat16``,
    ``float32``, ``int8``): None for float32 (its 3xTF32 fused tiles lost
    to the per-conv pipeline at every width on the H100) and for int8 with
    dynamic scales (their amax spans a conv's whole input row, a tile
    window of the TPU kernel, so a conv cannot start before its
    predecessor has finished every tile of the card's: one launch a conv,
    ``conv_route_name``)."""
    if route == "int8":
        return "int8" if int8_static else None
    return {"bfloat16": "bf16", "bf16": "bf16", "float32": None}[route]


def fused_route(store, quantize_int8: bool, act_scales) -> Optional[str]:
    """``fused_route_name`` of a ``fused_mrf`` call."""
    if quantize_int8:
        return fused_route_name("int8", act_scales is not None)
    return fused_route_name("bfloat16" if store == torch.bfloat16 else "float32")


def conv_route_name(route: str, int8_static: bool = False) -> str:
    """The per-conv wgmma pipeline's route (``CONV_ROUTES``) for a serving
    route (``bfloat16``, ``float32``, ``int8``): ``tf32`` is the float32
    route's 3xTF32, ``int8_dynamic`` int8 without calibrated scales."""
    if route == "int8":
        return "int8" if int8_static else "int8_dynamic"
    return {"bfloat16": "bf16", "bf16": "bf16", "float32": "tf32"}[route]


def conv_route(store, quantize_int8: bool, act_scales) -> str:
    """``conv_route_name`` of a ``fused_mrf`` call."""
    if quantize_int8:
        return conv_route_name("int8", act_scales is not None)
    return conv_route_name("bfloat16" if store == torch.bfloat16 else "float32")


def fused_mrf_tiled(
    x: torch.Tensor,
    weights: Sequence[Tuple],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    launch: FusedLaunch,
    *,
    bf16_dots: bool = False,
    quantize_int8: bool = False,
    act_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The MRF stack on the float32 stage trunk x [B, L, C] as the fused
    kernel schedules it (``launch``, from ``plan_fused``): every tile's
    window of ``win`` rows from ``tile * bm - halo``, zero outside [0, L);
    each conv computed on the rows its successors need (each input range
    shrinks by the conv's reach) and its output set to 0 outside [0, L);
    the ``bm`` centre rows summed over the resblocks.  Returns the float32
    [B, L, C] stage output.  ``bf16_dots`` rounds each conv's lrelu input
    as the bf16 route does; ``quantize_int8`` with ``act_scales`` runs the
    static int8 convs.  Used by the tests, to hold the schedule (tile rows,
    windows, re-zeroing) to ``fused_mrf_plain``."""
    B, L, C = x.shape
    h = x.float()
    convs = [len(d) * (1 if w2 is None else 2) for (_, _, w2, _), d in zip(weights, dilations)]
    H, W, bm, T = launch.halo, launch.win, launch.bm, launch.tiles_per_row
    pos = torch.arange(T)[:, None] * bm - H + torch.arange(W)[None, :]  # [T, W]
    valid = ((pos >= 0) & (pos < L)).to(h.device)
    win = h[:, pos.clamp(0, L - 1).reshape(-1)].reshape(B, T, W, C) * valid[None, :, :, None]
    win = win.reshape(B * T, W, C).transpose(1, 2)  # [tiles, C, W]
    keep = valid.repeat(B, 1)[:, None, :].float()  # [tiles, 1, W]
    tot = None
    for i in range(len(kernel_sizes)):
        w1, b1, w2, b2 = weights[i]
        k = kernel_sizes[i]
        lo = H - fused_halo(k, dilations[i], w2 is None)
        hi = W - lo
        index = sum(convs[:i])
        r = win
        for j, d in enumerate(dilations[i]):
            src = r
            steps = [(w1, b1, d)] + ([] if w2 is None else [(w2, b2, 1)])
            for cv, (w, b, dil) in enumerate(steps):
                inp = F.leaky_relu(src[:, :, lo:hi], LRELU_SLOPE)
                if quantize_int8:
                    y = _conv_int8(inp, w.codes[j], w.scales[j], b[j], dil, act_scales[index], same=False)
                else:
                    if bf16_dots:
                        inp = inp.to(torch.bfloat16).float()
                    y = F.conv1d(inp, _dense(w)[j].float().permute(2, 1, 0), b[j].float(), dilation=dil)
                index += 1
                p = (k - 1) // 2 * dil
                lo, hi = lo + p, hi - p
                y = y * keep[:, :, lo:hi]  # 0 outside [0, L): the next conv's SAME padding
                out = torch.zeros_like(r)
                out[:, :, lo:hi] = y + r[:, :, lo:hi] if cv == len(steps) - 1 else y
                src = out
            r = src
        centre = r[:, :, H:H + bm]
        tot = centre if tot is None else tot + centre
    out = tot / _f32(len(kernel_sizes), tot)  # [B * T, C, bm]
    return out.reshape(B, T, C, bm).permute(0, 1, 3, 2).reshape(B, T * bm, C)[:, :L].contiguous()


def fused_mrf_plain(
    x: torch.Tensor,
    weights: Sequence[Tuple],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    *,
    upsample: Optional[Tuple] = None,
    post: Optional[Tuple] = None,
    compute_dtype=torch.float32,
    quantize_int8: bool = False,
    act_scales: Optional[torch.Tensor] = None,
    bf16_dots: bool = False,
    tiles: bool = True,
) -> torch.Tensor:
    """Plain PyTorch twin of the stage kernels: float32 arithmetic, rounding
    to the storage dtype only where the kernel stores.  ``bf16_dots``
    rounds the lrelu input of every MRF conv and of the ConvTranspose
    prologue to bfloat16 before its float32 conv: the TPU kernel's
    DEFAULT-precision dot (``viettts_tpu/ops/mrf.py:336-340``) and the
    bf16 kernel's operands, used to hold that kernel to its function.
    Dynamic int8 runs the MRF and conv_post on the TPU kernel's tile
    windows (``dynamic_windows``); ``tiles=False`` runs it on each batch
    row whole, what one run of a card pipeline computes."""
    fused_mrf.plain_calls += 1
    h = x.float().transpose(1, 2)  # [B, C, L]
    if upsample is not None:
        w_t, b_t, u = upsample
        h, w = F.leaky_relu(h, LRELU_SLOPE), convt_weight_to_torch(_dense(w_t).float())
        if bf16_dots:
            h = h.to(torch.bfloat16).float()
        if quantize_int8:
            # as the kernel on this route: float64 sums of the exact float32
            # products, rounded once, then the float32 bias
            zero = torch.zeros(w.shape[1], dtype=torch.float64, device=h.device)
            h = conv_transpose_same(h.double(), w.double(), zero, u).float() + b_t.float()[None, :, None]
        else:
            h = conv_transpose_same(h, w, b_t.float(), u)
    if quantize_int8:
        def conv(inp, w, b, j, d, index):
            act = None if act_scales is None else act_scales[index]
            return _conv_int8(inp, w.codes[j], w.scales[j], b[j], d, act)
    else:
        def conv(inp, w, b, j, d, index):
            if bf16_dots:
                inp = inp.to(torch.bfloat16).float()
            return _conv_same(inp, _dense(w)[j], b[j], d)

    def stage(t):  # [B', C, L'] -> [B', C_out, L']
        acc = _mrf_stack(t, weights, kernel_sizes, dilations, conv)
        if post is not None:
            w_p, b_p = post
            acc = torch.tanh(_conv_same(F.leaky_relu(acc, POST_LRELU_SLOPE), w_p, b_p, 1))
        return acc

    run = None
    if quantize_int8 and act_scales is None and tiles:
        run = dynamic_windows(x, weights, kernel_sizes, dilations, upsample, post, storage_dtype(compute_dtype))
    if run is None:
        y = stage(h).transpose(1, 2)
    else:
        y = by_windows(h.transpose(1, 2).contiguous(), run, lambda t: stage(t.transpose(1, 2)).transpose(1, 2))
    return y.contiguous() if post is not None else y.contiguous().to(storage_dtype(compute_dtype))


def prepare_mrf_weights(
    weights, upsample=None, post=None, compute_dtype=torch.float32, quantize_int8=False
):
    """Cast a float32 weight set to what ``fused_mrf`` takes: weights in the
    storage dtype, biases in float32, all contiguous.  ``quantize_int8``
    turns W1/W2 into ``Int8Conv``, quantized from the float32 values (the
    TPU kernel packs and quantizes in float32, never from bf16), and the
    upsample weight into ``F64Conv``; on the float32 route they become
    ``Tf32Conv`` (split once here, not per call, with the per-conv wgmma
    pipeline's TF32 slots), on the bf16 route ``Bf16Conv`` with its
    slots."""
    store = storage_dtype(compute_dtype)

    def w(t):
        if t is None:
            return None
        t = _dense(t)
        if quantize_int8:
            return quantize_weight_int8(t.float())
        if store == torch.float32:
            t = t.float().contiguous()
            return Tf32Conv(t, tf32_split(t), tf32_slots(t))
        t = t.to(store).contiguous()
        return Bf16Conv(t, conv_slots(t))

    def b(t):
        return None if t is None else t.float().contiguous()

    weights = [(w(w1), b(b1), w(w2), b(b2)) for w1, b1, w2, b2 in weights]
    if upsample is not None:
        w_t = _dense(upsample[0])
        if quantize_int8:
            w_t = w_t.to(store).contiguous()
            w_t = F64Conv(w_t, w_t.double().transpose(-1, -2).contiguous())
        elif store == torch.float32:
            w_t = w_t.float().contiguous()
            w_t = Tf32Conv(w_t, tf32_split(w_t[None])[0])
        else:
            w_t = w_t.to(store).contiguous()
        upsample = (w_t, b(upsample[1]), int(upsample[2]))
    if post is not None:
        post = (post[0].to(store).contiguous(), b(post[1]))
    return weights, upsample, post


def _check(x, weights, kernel_sizes, dilations, upsample, post, store, quantize_int8, act_scales):
    """Validate shapes, dtypes, devices and contiguity; returns (L, C).  The
    kernels' layouts (``Int8Conv.kmajor``, ``F64Conv``) are checked where
    present and required on every device but the CPU."""
    kernel = x.device.type != "cpu"
    if x.dim() != 3 or x.dtype != store:
        raise ValueError(f"fused_mrf: x must be [B, L, C] {store}, got {tuple(x.shape)} {x.dtype}")
    if len(weights) != len(kernel_sizes) or len(dilations) != len(kernel_sizes):
        raise ValueError("fused_mrf: weights, kernel_sizes and dilations differ in length")
    tensors = [("x", x, store)]
    if upsample is not None:
        w_t, b_t, u = upsample
        k_u, c_in, C = _dense(w_t).shape
        if c_in != x.shape[2] or tuple(b_t.shape) != (C,):
            raise ValueError(f"fused_mrf: upsample weight {tuple(_dense(w_t).shape)} does not fit x {tuple(x.shape)}")
        L = x.shape[1] * u
        tensors += [("upsample w", _dense(w_t), store), ("upsample b", b_t, torch.float32)]
        if isinstance(w_t, Tf32Conv):
            if tuple(w_t.split.shape) != (2, k_u, C, c_in):
                raise ValueError(f"fused_mrf: upsample TF32 split {tuple(w_t.split.shape)}, want {(2, k_u, C, c_in)}")
            tensors += [("upsample split", w_t.split, torch.float32)]
        if quantize_int8:
            if isinstance(w_t, F64Conv):
                if tuple(w_t.kmajor.shape) != (k_u, C, c_in):
                    raise ValueError(f"fused_mrf: upsample float64 K-major weight {tuple(w_t.kmajor.shape)}, "
                                     f"want {(k_u, C, c_in)}")
                tensors += [("upsample kmajor", w_t.kmajor, torch.float64)]
            elif kernel:
                raise ValueError("fused_mrf kernel: the int8 route's upsample weight must be F64Conv "
                                 "(prepare_mrf_weights)")
    else:
        L, C = x.shape[1], x.shape[2]
    for blk, k in enumerate(kernel_sizes):
        w1, b1, w2, b2 = weights[blk]
        n = len(dilations[blk])
        if k % 2 != 1:
            raise ValueError(f"fused_mrf: resblock kernel size {k} must be odd")
        for name, w, b in (("W1", w1, b1), ("W2", w2, b2)):
            if w is None and name == "W2":
                if b is not None:
                    raise ValueError("fused_mrf: W2 is None but B2 is not")
                continue
            if isinstance(w, Int8Conv) != quantize_int8:
                raise ValueError(
                    f"fused_mrf: block {blk} {name} must {'' if quantize_int8 else 'not '}be an "
                    f"Int8Conv with quantize_int8={quantize_int8}"
                )
            codes = w.codes if quantize_int8 else _dense(w)
            if tuple(codes.shape) != (n, k, C, C) or tuple(b.shape) != (n, C):
                raise ValueError(
                    f"fused_mrf: block {blk} {name} {tuple(codes.shape)} / bias {tuple(b.shape)}, "
                    f"want {(n, k, C, C)} / {(n, C)}"
                )
            if quantize_int8:
                if tuple(w.scales.shape) != (n, C):
                    raise ValueError(f"fused_mrf: block {blk} {name} scales {tuple(w.scales.shape)}, want {(n, C)}")
                tensors += [(f"{name}[{blk}] codes", w.codes, torch.int8),
                            (f"{name}[{blk}] scales", w.scales, torch.float32)]
                if w.kmajor is not None:
                    if tuple(w.kmajor.shape) != (n, k, C, C):
                        raise ValueError(f"fused_mrf: block {blk} {name} K-major codes {tuple(w.kmajor.shape)}, "
                                         f"want {(n, k, C, C)}")
                    tensors += [(f"{name}[{blk}] kmajor", w.kmajor, torch.int8)]
                elif kernel:
                    raise ValueError(f"fused_mrf kernel: block {blk} {name} has no K-major codes "
                                     "(quantize_weight_int8)")
            else:
                tensors += [(f"{name}[{blk}]", _dense(w), store)]
                if isinstance(w, Tf32Conv):
                    if tuple(w.split.shape) != (n, 2, k, C, C):
                        raise ValueError(f"fused_mrf: block {blk} {name} TF32 split {tuple(w.split.shape)}, "
                                         f"want {(n, 2, k, C, C)}")
                    tensors += [(f"{name}[{blk}] split", w.split, torch.float32)]
            tensors += [(f"B{name[1]}[{blk}]", b, torch.float32)]
    if act_scales is not None:
        if not quantize_int8:
            raise ValueError("fused_mrf: act_scales needs quantize_int8=True")
        if tuple(act_scales.shape) != (n_convs(weights),):
            raise ValueError(f"fused_mrf: act_scales {tuple(act_scales.shape)}, want ({n_convs(weights)},)")
        tensors += [("act_scales", act_scales, torch.float32)]
    if post is not None:
        w_p, b_p = post
        kp, c, cp = w_p.shape
        if c != C or tuple(b_p.shape) != (cp,) or kp % 2 != 1:
            raise ValueError(f"fused_mrf: post weight {tuple(w_p.shape)} does not fit C={C}")
        tensors += [("post w", w_p, store), ("post b", b_p, torch.float32)]
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise ValueError(f"fused_mrf: {name} is {t.dtype}, want {dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_mrf: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mrf: {name} is not contiguous")
    return L, C


def fused_mrf(
    x: torch.Tensor,
    weights: Sequence[Tuple],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    *,
    upsample: Optional[Tuple] = None,
    post: Optional[Tuple] = None,
    compute_dtype=torch.float32,
    quantize_int8: bool = False,
    act_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply one (ConvTranspose +) MRF (+ conv_post) stage.

    Without ``upsample`` x is [B, L, C]; with it x is [B, L/u, C_in].
    Returns [B, L, C] in the storage dtype, or the float32 [B, L, C_post]
    waveform when ``post`` is given.  ``quantize_int8`` / ``act_scales``:
    see the module docstring.
    """
    store = storage_dtype(compute_dtype)
    L, C = _check(x, weights, kernel_sizes, dilations, upsample, post, store, quantize_int8, act_scales)
    kwargs = dict(
        upsample=upsample, post=post, compute_dtype=compute_dtype,
        quantize_int8=quantize_int8, act_scales=act_scales,
    )
    if x.device.type == "cpu":
        return fused_mrf_plain(x, weights, kernel_sizes, dilations, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf: no kernel for device {x.device}")
    if post is not None and post[0].shape[2] > MAX_POST_CHANNELS:
        raise ValueError(f"fused_mrf kernel takes at most {MAX_POST_CHANNELS} post channels")
    if store == torch.float32 and not quantize_int8:
        ws = [w for w1, _, w2, _ in weights for w in (w1, w2)] + ([upsample[0]] if upsample else [])
        if not all(w is None or isinstance(w, Tf32Conv) for w in ws):
            raise ValueError("fused_mrf kernel: float32 weights must be Tf32Conv (prepare_mrf_weights)")
    return _fused_mrf_cuda(
        x, weights, kernel_sizes, dilations, upsample, post, store, L, C, quantize_int8, act_scales
    )


def _on_input_device(fn):
    """Run a wrapper that launches kernels with the input's CUDA device
    current: the library launches on the current device and keeps its
    per-device state (shared-memory opt-ins, SM counts) for it."""

    @functools.wraps(fn)
    def wrapped(x, *args, **kwargs):
        with torch.cuda.device(x.device):
            return fn(x, *args, **kwargs)

    return wrapped


@_on_input_device
def _fused_mrf_cuda(
    x, weights, kernel_sizes, dilations, upsample, post, store, L, C, quantize_int8, act_scales
):
    lib = _build.load_library()
    stream = _build.stream_ptr(x.device)
    bf = int(store == torch.bfloat16)
    B = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    # K3 runs the int8 route's MRF convs and its prologue; K2 still runs
    # the epilogue and a bf16 input's cast
    if not quantize_int8 or post is not None or store != torch.float32:
        fused_mrf.launches += 1

    if upsample is not None:
        w_t, b_t, u = upsample
        # tensor cores, u interleaved stride-1 convs of a float32 input
        xf = x
        if store == torch.bfloat16:
            xf = torch.empty(x.shape, **f32)
            _build.check(lib.viettts_mrf_to_f32(x.data_ptr(), xf.data_ptr(), x.numel(), stream),
                         "fused_mrf prologue input cast")
        if quantize_int8:  # float64 sums: the int8 codes depend on them
            h = convt_f64(xf, w_t, b_t, u)
        else:
            k_u, c_in, _ = _dense(w_t).shape
            h = torch.empty(B, L, C, **f32)
            wk = w_t.split if isinstance(w_t, Tf32Conv) else w_t
            _build.check(
                lib.viettts_mrf_convt_mma(
                    bf, xf.data_ptr(), wk.data_ptr(), b_t.data_ptr(), h.data_ptr(),
                    B, x.shape[1], c_in, C, k_u, u, convt_lead_pad(k_u, u), -1, stream,
                ),
                "fused_mrf prologue",
            )
    elif store == torch.float32:
        h = x  # read only: the MRF never writes its trunk
    else:
        h = torch.empty(B, L, C, **f32)
        _build.check(
            lib.viettts_mrf_to_f32(x.data_ptr(), h.data_ptr(), x.numel(), stream),
            "fused_mrf input cast",
        )

    if quantize_int8:
        fused_mrf.int8_launches += 1
    args = (lib, stream, bf, weights, kernel_sizes, dilations, post, store, quantize_int8, act_scales)
    run = None
    if quantize_int8 and act_scales is None:
        run = dynamic_windows(x, weights, kernel_sizes, dilations, upsample, post, store)
    if run is None:
        return _stage_cuda(h, *args)
    if _takes_conv_wgmma("int8_dynamic", B * run.n, run.length, C, kernel_sizes, h.device):
        # one run of every window, on the full trunk: no copies
        out = torch.empty(B, L, C, dtype=store, device=x.device) if post is None else \
            torch.empty(B * run.n, run.length, C, **f32)
        _launch_conv_wgmma(lib, stream, "int8_dynamic", h, weights, kernel_sizes, dilations, None, out,
                           int(post is None and store == torch.bfloat16), run)
        fused_mrf.int8_dynamic_conv_launches += 1
        if post is None:
            return out
        wave = _post(lib, stream, bf, out, post)
        tiles = wave.view(run.n, B, run.length, -1)[:, :, run.halo:run.halo + run.tile]
        return tiles.permute(1, 0, 2, 3).reshape(B, L, -1)
    return by_windows(h, run, lambda hw: _stage_cuda(hw, *args))  # mma_conv_kernel: no window variant


def _takes_conv_wgmma(croute, B, L, C, kernel_sizes, device) -> bool:
    """Whether a stage's MRF convs go to the per-conv wgmma pipeline: the
    router's answer (``CONV_WGMMA`` True), or any shape its plan tiles
    ("any"), or none (False)."""
    if CONV_WGMMA is True:
        return conv_takes(croute, B, L, C)
    return CONV_WGMMA == "any" and conv_plan(B, L, C, kernel_sizes[0], 1, _sm_count(device), croute) is not None


def _stage_cuda(h, lib, stream, bf, weights, kernel_sizes, dilations, post, store, quantize_int8, act_scales):
    """The stage after its prologue, on the float32 trunk h [B, L, C]: the
    MRF convs on the pipeline that takes them, then any conv_post."""
    B, L, C = h.shape
    f32 = dict(dtype=torch.float32, device=h.device)
    n_blocks = len(kernel_sizes)
    out_dtype = torch.float32 if post is not None else store
    out = torch.empty(B, L, C, dtype=out_dtype, device=h.device)
    out_bf = int(out_dtype == torch.bfloat16)
    route = fused_route(store, quantize_int8, act_scales)
    launch = None
    if route is not None and C in FUSED_CHANNELS:
        launch = plan_fused(route, C, kernel_sizes, dilations, weights[0][2] is None, B, L, _sm_count(h.device))
    if launch is not None:
        _launch_fused(lib, stream, route, h, weights, kernel_sizes, dilations, act_scales, launch, out, out_bf)
        return out if post is None else _post(lib, stream, bf, out, post)
    croute = conv_route(store, quantize_int8, act_scales)
    if _takes_conv_wgmma(croute, B, L, C, kernel_sizes, h.device):
        _launch_conv_wgmma(lib, stream, croute, h, weights, kernel_sizes, dilations, act_scales, out, out_bf)
        counter = CONV_COUNTERS[croute]
        setattr(fused_mrf, counter, getattr(fused_mrf, counter) + 1)
        return out if post is None else _post(lib, stream, bf, out, post)

    # mma_conv_kernel: the stages neither wgmma pipeline takes (dynamic
    # int8: one amax per (conv, batch row), by atomicMax)
    bufs = (torch.empty(B, L, C, **f32), torch.empty(B, L, C, **f32))
    acc = torch.empty(B, L, C, **f32) if n_blocks > 1 else None
    amax = torch.zeros(n_convs(weights), B, **f32) if quantize_int8 and act_scales is None else None
    index = 0

    def other(t):
        return bufs[1] if t is bufs[0] else bufs[0]

    # address of row j of a contiguous tensor: each tensor's base and row
    # stride are read once per call
    addr = {}

    def row(t, j=0):
        if t is None:
            return 0
        a = addr.get(id(t))
        if a is None:
            a = addr[id(t)] = (t.data_ptr(), t.stride(0) * t.element_size())
        return a[0] + j * a[1]

    # the stage's convs go to the card as one launch plan (one host call:
    # a call per conv costs about a small conv's device time), rows as in
    # csrc/mrf_common.cuh (PLAN_FIELDS)
    plan = []

    def conv(inp, w, b, j, k, d, res, y, mode=0, out_ptr=0):
        # mode 0: y = v; 1: y += v; 2: out = ((y or 0) + v) / n_blocks,
        # where v = conv_k,d(lrelu(inp)) + b (+ res)
        nonlocal index
        if not quantize_int8:
            wj = row(w.split if isinstance(w, Tf32Conv) else _dense(w), j)
            plan.extend((row(inp), wj, row(b, j), row(res), row(y), out_ptr, 0, 0, k, d, mode, 0, 0))
            return
        if amax is None:
            act, act_stride, dynamic = row(act_scales, index), 0, 0
        else:
            act, act_stride, dynamic = row(amax, index), 1, 1
        plan.extend((row(inp), row(w.kmajor, j), row(b, j), row(res), row(y), out_ptr,
                     row(w.scales, j), act, k, d, mode, act_stride, dynamic))
        index += 1

    for blk, k in enumerate(kernel_sizes):
        w1, b1, w2, b2 = weights[blk]
        cur = h
        dils = dilations[blk]
        for j, d in enumerate(dils):
            if w2 is not None:  # ResBlock1: dilated conv, then a dilation-1 conv
                t = other(cur)
                conv(cur, w1, b1, j, k, d, None, t)
                src, w, b, dil = t, w2, b2, 1
            else:  # ResBlock2: one dilated conv
                src, w, b, dil = cur, w1, b1, d
            if j < len(dils) - 1:
                # never the conv's own input (other blocks read its halo);
                # writing over the residual is safe: each element is read
                # and written by the same thread
                dst = other(src)
                conv(src, w, b, j, k, dil, cur, dst)
                cur = dst
            elif blk < n_blocks - 1:
                conv(src, w, b, j, k, dil, cur, acc, mode=0 if blk == 0 else 1)
            else:
                conv(src, w, b, j, k, dil, cur, acc, mode=2, out_ptr=out.data_ptr())

    rows = (ctypes.c_longlong * len(plan))(*plan)
    n = len(plan) // PLAN_FIELDS
    if quantize_int8:
        code = lib.viettts_mrf_conv_int8_plan(out_bf, B, L, C, float(n_blocks), n, ctypes.addressof(rows), stream)
    else:
        code = lib.viettts_mrf_conv_plan(bf, out_bf, B, L, C, float(n_blocks), n, ctypes.addressof(rows), stream)
    _build.check(code, "fused_mrf int8 convs" if quantize_int8 else "fused_mrf convs")

    return out if post is None else _post(lib, stream, bf, out, post)


def _post(lib, stream, bf, out, post):
    """The conv_post epilogue (leaky_relu(0.01), conv, tanh) on the stage
    output [B, L, C] float32."""
    w_p, b_p = post
    kp, _, cp = w_p.shape
    B, L, C = out.shape
    wave = torch.empty(B, L, cp, dtype=torch.float32, device=out.device)
    _build.check(
        lib.viettts_mrf_post(
            bf, out.data_ptr(), w_p.data_ptr(), b_p.data_ptr(), wave.data_ptr(),
            B, L, C, cp, kp, stream,
        ),
        "fused_mrf epilogue",
    )
    return wave


@functools.lru_cache(maxsize=None)
def _device_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device) -> int:
    return _device_sms(device.index if device.index is not None else torch.cuda.current_device())


def _launch_fused(lib, stream, route, h, weights, kernel_sizes, dilations, act_scales, launch, out, out_bf):
    """The stage's MRF on the fused pipeline: h the float32 trunk [B, L, C],
    one C call for ``launch`` (``plan_fused``) with its table of
    FUSED_RES_FIELDS int64 a resblock."""
    B, L, C = h.shape
    convs = [len(d) * (1 if w2 is None else 2) for (_, _, w2, _), d in zip(weights, dilations)]

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    rows = []
    for i, (w1, b1, w2, b2) in enumerate(weights):
        dils = list(dilations[i]) + [0] * (FUSED_MAX_UNITS - len(dilations[i]))
        if route == "int8":  # the K-major codes and their scales
            ws = [w1.kmajor.data_ptr(), 0 if w2 is None else w2.kmajor.data_ptr(), ptr(b1), ptr(b2),
                  w1.scales.data_ptr(), 0 if w2 is None else w2.scales.data_ptr()]
        else:
            ws = [ptr(_dense(w1)), ptr(_dense(w2)), ptr(b1), ptr(b2), 0, 0]
        rows += [*ws, kernel_sizes[i], len(dilations[i]), sum(convs[:i]), *dils]
    table = (ctypes.c_longlong * len(rows))(*rows)
    args = (B, L, C, launch.n_res, launch.win, launch.bm, launch.stages, launch.ctas, h.data_ptr(),
            ctypes.addressof(table))
    if route == "int8":
        code = lib.viettts_mrf_fused_int8(out_bf, *args, act_scales.data_ptr(), out.data_ptr(), stream)
    else:
        code = lib.viettts_mrf_fused(out_bf, *args, out.data_ptr(), stream)
    _build.check(code, f"fused_mrf {route} resblocks")


# The per-conv wgmma pipeline's operand on each route: (element dtype, e
# channels a 16-byte plane, planes an element takes: tf32 stores hi and lo)
CONV_OPERANDS = {"bf16": (torch.bfloat16, 8, 1), "int8": (torch.int8, 16, 1),
                 "int8_dynamic": (torch.int8, 16, 1), "tf32": (torch.float32, 4, 2)}
# the counter of each route's stages on it (``fused_mrf.<name>``)
CONV_COUNTERS = {"bf16": "conv_launches", "int8": "int8_conv_launches", "tf32": "tf32_conv_launches",
                 "int8_dynamic": "int8_dynamic_conv_launches"}


def _launch_conv_wgmma(lib, stream, route, h, weights, kernel_sizes, dilations, act_scales, out, out_bf,
                       run=None):
    """The stage's MRF convs on the per-conv wgmma pipeline on ``route``
    (``CONV_ROUTES``): h the float32 trunk [B, L, C]; the stage input's
    operands (one bf16 or TF32 tensor, the int8 codes at each resblock's
    first static scale, or with dynamic scales one code tensor at the row
    amax of lrelu(h)), then the convs from a table of ``CONV_FIELDS`` int64
    a conv, in one C call.  Each conv reads one chunk-major operand and
    writes the next conv's into another (a conv's halo is other tiles'
    rows, so never its own input): ResBlock1's dilated conv writes ``pa``,
    its dilation-1 conv ``pb``; ResBlock2's convs alternate between the
    two.  With dynamic scales a conv that writes an operand also writes
    float32 (the trunk, or ``mid`` for ResBlock1's dilated conv), which its
    quantize pass reads, and each conv's amax is a row of ``amax`` [n_convs,
    B] (the stage input's: row 0).  ``run`` (dynamic int8: the stage's
    ``TileRun``) makes the batch rows the stage's tile windows, of
    ``run.length`` steps: h is then the full-sequence trunk, read at each
    window's rows (zero outside the sequence, where every conv's output is
    zeroed too), and ``out``, full-sequence unless a conv_post follows, gets
    each window's tile."""
    B, L, C = h.shape
    if run is not None:
        B, L = B * run.n, run.length
    f32 = dict(dtype=torch.float32, device=h.device)
    op_dtype, e, parts = CONV_OPERANDS[route]
    int8 = route.startswith("int8")
    dynamic = route == "int8_dynamic"

    def operand():
        return torch.empty(B, C // e * parts, L, e, dtype=op_dtype, device=h.device)

    def ptr(t, j=0):
        return 0 if t is None else t.data_ptr() + j * t.stride(0) * t.element_size()

    n_blocks = len(kernel_sizes)
    convs = [len(d) * (1 if w2 is None else 2) for (_, _, w2, _), d in zip(weights, dilations)]
    firsts = [sum(convs[:i]) for i in range(n_blocks)]
    sms = _sm_count(h.device)
    for blk, (w1, _, w2, _) in enumerate(weights):
        plan = conv_plan(B, L, C, kernel_sizes[blk], 1, sms, route)
        if plan is None:
            raise ValueError(f"fused_mrf kernel: the wgmma pipeline's plan does not tile C={C} on route {route}")
        kc = plan.planes // parts * e
        for name, w in (("W1", w1), ("W2", w2)):
            if w is None:
                continue
            slots = getattr(w, "slots", None)
            want = (convs[blk] // (1 if w2 is None else 2), C // kc, kernel_sizes[blk], plan.planes, C, e)
            if slots is None or tuple(slots.shape) != want or slots.dtype != op_dtype or not slots.is_contiguous():
                raise ValueError(f"fused_mrf kernel: block {blk} {name} needs its wgmma weight slots {want} {op_dtype} "
                                 f"(prepare_mrf_weights), got "
                                 f"{None if slots is None else (tuple(slots.shape), slots.dtype)}")
            if slots.device != h.device:
                raise ValueError(f"fused_mrf: block {blk} {name} slots are on {slots.device}, x on {h.device}")
    amax = torch.empty(n_convs(weights), B, **f32) if dynamic else None
    # the stage input's operands (the row array must outlive the call)
    if route in ("bf16", "tf32"):
        h_ops = [operand()] * n_blocks
        rows = (ctypes.c_longlong * 2)(h_ops[0].data_ptr(), 0)
        fn = lib.viettts_mrf_conv_operands if route == "bf16" else lib.viettts_mrf_conv_operands_tf32
        _build.check(fn(B, L, C, h.data_ptr(), 1, ctypes.addressof(rows), stream), f"fused_mrf {route} stage operands")
    elif dynamic:  # written by the stage's C call, at amax row 0
        h_ops = [operand()] * n_blocks
    else:
        h_ops = [operand() for _ in range(n_blocks)]
        pairs = [v for i, op in enumerate(h_ops) for v in (op.data_ptr(), ptr(act_scales, firsts[i]))]
        rows = (ctypes.c_longlong * len(pairs))(*pairs)
        code = lib.viettts_mrf_conv_operands_int8(B, L, C, h.data_ptr(), n_blocks, ctypes.addressof(rows), stream)
        _build.check(code, f"fused_mrf {route} stage operands")

    trunk = torch.empty(B, L, C, **f32) if any(len(d) > 1 for d in dilations) else None
    acc = torch.empty(B, L, C, **f32) if n_blocks > 1 else None
    mid = torch.empty(B, L, C, **f32) if dynamic and any(w2 is not None for _, _, w2, _ in weights) else None
    pa, pb = operand(), operand()
    scales = amax if dynamic else act_scales
    table = []

    def conv(x_op, w, j, b, ci, k, dil, res=None, y=None, mode=0, out_ptr=0, pout=None):
        wslots = ptr(w.slots, j)
        scale = ptr(w.scales, j) if int8 else 0
        act = ptr(scales, 0 if dynamic and x_op is h_ops[0] else ci) if int8 else 0
        act_next = ptr(scales, ci + 1) if int8 and pout is not None else 0
        table.extend((x_op.data_ptr(), wslots, ptr(b, j), scale, act, act_next, ptr(res), ptr(y), out_ptr, ptr(pout),
                      k, dil, mode))

    for blk, k in enumerate(kernel_sizes):
        w1, b1, w2, b2 = weights[blk]
        dils = dilations[blk]
        cur, res, ci = h_ops[blk], h, firsts[blk]
        for j, d in enumerate(dils):
            if w2 is not None:  # ResBlock1: the dilated conv writes only its successor's operand
                conv(cur, w1, j, b1, ci, k, d, y=mid, pout=pa)
                ci += 1
                src, w, b, dil, nxt = pa, w2, b2, 1, pb
            else:
                src, w, b, dil, nxt = cur, w1, b1, d, (pb if cur is pa else pa)
            if j < len(dils) - 1:
                conv(src, w, j, b, ci, k, dil, res=res, y=trunk, pout=nxt)
                cur, res = nxt, trunk
            elif blk < n_blocks - 1:
                conv(src, w, j, b, ci, k, dil, res=res, y=acc, mode=0 if blk == 0 else 1)
            else:
                conv(src, w, j, b, ci, k, dil, res=res, y=acc, mode=2, out_ptr=out.data_ptr())
            ci += 1

    rows = (ctypes.c_longlong * len(table))(*table)
    n = len(table) // CONV_FIELDS
    args = (out_bf, B, L, C, float(n_blocks), n, ctypes.addressof(rows))
    if dynamic:
        w = run or TileRun(0, 0, 0, 0, 0, 0)
        code = lib.viettts_mrf_conv_wgmma_int8_dynamic(*args, h.data_ptr(), h_ops[0].data_ptr(), amax.data_ptr(),
                                                       amax.shape[0], w.n, w.B, w.tile, w.halo, w.seq,
                                                       int(run is not None and out.shape[0] == w.B), stream)
    else:
        fn = {"bf16": lib.viettts_mrf_conv_wgmma, "int8": lib.viettts_mrf_conv_wgmma_int8,
              "tf32": lib.viettts_mrf_conv_wgmma_tf32}[route]
        code = fn(*args, stream)
    _build.check(code, f"fused_mrf {route} wgmma convs")


CONV_FIELDS = 13  # int64 fields of a conv in the wgmma pipeline's launch table (csrc/mrf_conv_wgmma.cuh)


class ConvPlan(NamedTuple):
    """One conv's launch on the per-conv wgmma pipeline, as the C plan
    (``csrc/mrf_conv_plan.h``) gives it: tiles of ``bm`` rows x ``bn``
    channels, K chunks of ``planes`` 16-byte planes, a weight ring of
    ``stages`` slots, windows of ``win`` rows (TMA boxes of ``xbox``),
    ``tiles`` tiles over ``ctas`` persistent blocks, ``smem`` bytes of
    shared memory."""

    bm: int
    bn: int
    planes: int
    stages: int
    win: int
    xbox: int
    tiles: int
    ctas: int
    smem: int


@functools.lru_cache(maxsize=1024)
def conv_takes(route: str, B: int, L: int, C: int) -> bool:
    """Whether the per-conv wgmma pipeline takes a stage's MRF convs on
    ``route`` (``CONV_ROUTES``; a fused route name is the same for bf16 and
    static int8): the C plan's answer."""
    if route not in CONV_ROUTES:
        return False
    return bool(_build.load_plan_library().viettts_conv_wgmma_takes(CONV_ROUTES[route], B, L, C))


@functools.lru_cache(maxsize=1024)
def conv_plan(B: int, L: int, C: int, k: int, dil: int, sms: int, route: str = "bf16") -> Optional[ConvPlan]:
    """The C plan's launch of one conv (kernel size k, dilation dil) of a
    stage of width C, B rows of L steps, on ``route`` on a card of ``sms``
    SMs; None where no tile fits."""
    out = (ctypes.c_int * len(ConvPlan._fields))()
    if not _build.load_plan_library().viettts_conv_wgmma_plan(CONV_ROUTES[route], B, L, C, k, dil, sms,
                                                              ctypes.addressof(out)):
        return None
    return ConvPlan(*out)


def conv_issued_macs(B: int, L: int, C: int, kernel_sizes, dilations, resblock2: bool, sms: int,
                     route: str = "bf16") -> int:
    """MACs the per-conv wgmma pipeline issues for a stage's MRF convs on
    ``route``: each conv's tiles (``bm`` rows x ``bn`` channels, the ragged
    last row tile whole) over k taps and C input channels (3xTF32 issues
    three tensor-core products for each)."""
    total = 0
    for k, dils in zip(kernel_sizes, dilations):
        for d in dils:
            for dil in (d,) if resblock2 else (d, 1):
                p = conv_plan(B, L, C, k, dil, sms, route)
                total += p.tiles * p.bm * p.bn * k * C
    return total


def row_amax(y: torch.Tensor) -> torch.Tensor:
    """The dynamic int8 scale of a conv input y [B, C, L]: its amax over
    each batch row, as ``_conv_int8`` takes it."""
    return y.abs().amax(dim=(1, 2))


def operand_of(v: torch.Tensor, route: str, act: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stored operand of a conv whose input is lrelu(v) [B, C, L]:
    bf16(lrelu(v)); on the int8 route the codes at the calibrated amax
    ``act`` (as ``_conv_int8`` quantizes its input), on ``int8_dynamic`` at
    the row amax [B] ``act`` (no clip; ``row_amax`` where None); on
    ``tf32`` its TF32 parts hi and lo stacked on a new axis 1."""
    y = F.leaky_relu(v.float(), LRELU_SLOPE)
    if route == "bf16":
        return y.to(torch.bfloat16)
    if route == "tf32":
        return torch.stack(tf32_parts(y), dim=1)
    c127 = _f32(127.0, y)
    if route == "int8_dynamic":
        a = row_amax(y) if act is None else act
        return torch.round(y * (c127 / torch.clamp_min(a, 1e-30))[:, None, None]).to(torch.int8)
    return torch.round(torch.clamp(y * (c127 / torch.clamp_min(act, 1e-12)), -127.0, 127.0)).to(torch.int8)


def pack_operand(op: torch.Tensor) -> torch.Tensor:
    """An operand [B, C, L] (bf16 or int8 codes) in the kernel's chunk-major
    layout [B, C / e, L, e] (e = 16 bytes of channels): channel c of row l
    at flat element ((b * C / e + c / e) * L + l) * e + c % e.  A TF32
    operand [B, 2, C, L] (hi, lo) goes to [B, C / 2, L, 4]: for each chunk
    of 16 channels its 4 planes of hi, then its 4 of lo."""
    if op.dim() == 4:
        B, _, C, L = op.shape
        return op.reshape(B, 2, C // 16, 4, 4, L).permute(0, 2, 1, 3, 5, 4).reshape(B, C // 2, L, 4).contiguous()
    B, C, L = op.shape
    e = 16 // op.element_size()
    return op.reshape(B, C // e, e, L).transpose(2, 3).contiguous()


def unpack_operand(p: torch.Tensor) -> torch.Tensor:
    """``pack_operand``'s inverse: [B, C / e, L, e] -> [B, C, L]; float32
    (TF32) [B, C / 2, L, 4] -> [B, 2, C, L]."""
    B, n, L, e = p.shape
    if p.dtype == torch.float32:
        return p.reshape(B, n // 8, 2, 4, L, 4).permute(0, 2, 1, 3, 5, 4).reshape(B, 2, n * 2, L)
    return p.transpose(2, 3).reshape(B, n * e, L)


def mrf_conv_stage_plain(
    x: torch.Tensor,
    weights: Sequence[Tuple],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    route: str,
    act_scales: Optional[torch.Tensor] = None,
    operands: Optional[List[torch.Tensor]] = None,
    amaxes: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """The MRF stack on the float32 stage trunk x [B, L, C] with the per-conv
    wgmma pipeline's storage, in plain PyTorch: every conv reads a stored,
    chunk-major operand (``pack_operand`` of ``operand_of``) that the
    previous conv's epilogue (or, for the stage input, one pass) wrote;
    float32 is kept only for the residual trunk and the resblocks' sum.
    ``route``: ``bf16`` (bf16 operands, float32 convs of their values),
    ``int8`` (codes at ``act_scales``, ``_conv_int8``'s dot and dequant),
    ``int8_dynamic`` (codes at each conv input's row amax, which
    ``amaxes``, where given, collects in flat conv order; the stage input's
    codes serve every resblock's first conv) or ``tf32`` (the TF32 parts
    of each operand and weight, a_lo * w_hi + a_hi * w_lo + a_hi * w_hi
    summed in float64, then rounded to float32 and the bias added).
    Returns the float32 [B, L, C] stage output, which equals
    ``fused_mrf_plain``'s (``bf16_dots=True`` on the bf16 route; int8 with
    the same ``act_scales``, or none on ``int8_dynamic``) bit for bit, and
    on ``tf32`` its float32 route to 3xTF32's precision; ``operands``,
    where given, collects every stored operand in launch order."""
    h = x.float().transpose(1, 2)  # [B, C, L]
    stored = operands if operands is not None else []
    rows = amaxes if amaxes is not None else []
    dynamic = route == "int8_dynamic"

    def store(v, index):
        act = None
        if route == "int8":
            act = act_scales[index]
        elif dynamic:
            act = row_amax(F.leaky_relu(v.float(), LRELU_SLOPE))
        stored.append(pack_operand(operand_of(v, route, act)))
        return stored[-1], act

    def conv(p, w, b, j, d, index):
        op, act = p
        if dynamic:
            rows.append(act)
        op = unpack_operand(op)
        k = _dense(w).shape[1] if route in ("bf16", "tf32") else w.codes.shape[1]
        pad = d * (k - 1) // 2
        if route == "tf32":
            w_hi, w_lo = (t.double().permute(2, 1, 0) for t in tf32_parts(_dense(w)[j].float()))
            a_hi, a_lo = op[:, 0].double(), op[:, 1].double()
            dot = sum(F.conv1d(a, wt, padding=pad, dilation=d) for a, wt in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)))
            return dot.float() + b[j][None, :, None]
        if route.startswith("int8"):
            if dynamic:
                mult = ((act * (1.0 / 127.0))[:, None] * w.scales[j][None, :])[..., None]
            else:
                a = torch.clamp_min(act_scales[index], 1e-12)
                mult = (w.scales[j] * (a / _f32(127.0, a)))[None, :, None]
            dot = F.conv1d(op.double(), w.codes[j].double().permute(2, 1, 0), padding=pad, dilation=d)
            return dot.float() * mult + b[j][None, :, None]
        return _conv_same(op.float(), _dense(w)[j], b[j], d)

    index, acc = 0, None
    h_op = store(h, 0) if route in ("bf16", "tf32", "int8_dynamic") else None
    for blk in range(len(kernel_sizes)):
        w1, b1, w2, b2 = weights[blk]
        r = h
        cur = h_op if h_op is not None else store(h, index)
        for j, d in enumerate(dilations[blk]):
            y = conv(cur, w1, b1, j, d, index)
            index += 1
            if w2 is not None:
                y = conv(store(y, index), w2, b2, j, 1, index)
                index += 1
            r = y + r
            if j < len(dilations[blk]) - 1:
                cur = store(r, index)
        acc = r if acc is None else acc + r
    return (acc / _f32(len(kernel_sizes), acc)).transpose(1, 2).contiguous()


def convt_f64(x: torch.Tensor, w_t: F64Conv, b_t: torch.Tensor, u: int, tile: int = -1) -> torch.Tensor:
    """The int8 route's ConvTranspose prologue on the card's FP64 tensor
    cores (``csrc/mrf_int8.cu``): x float32 [B, L_in, C_in] (CUDA) ->
    float32 [B, L_in * u, C], ``float(sum of lrelu(x) * w in float64) + b``,
    the twin's prologue with its float64 sums in another order.  ``tile``
    indexes the kernel's tile shapes (-1: picked from the problem size).
    Counts nothing: ``fused_mrf`` counts the stage."""
    k_u, c_in, C = w_t.w.shape
    B, L_in, _ = x.shape
    if x.dtype != torch.float32 or x.device.type != "cuda" or not x.is_contiguous() or x.shape[2] != c_in:
        raise ValueError(f"convt_f64: x must be a contiguous CUDA float32 [B, L, {c_in}], "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    lib = _build.load_library()
    h = torch.empty(B, L_in * u, C, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.check(
            lib.viettts_mrf_convt_f64(
                x.data_ptr(), w_t.kmajor.data_ptr(), b_t.data_ptr(), h.data_ptr(),
                B, L_in, c_in, C, k_u, u, convt_lead_pad(k_u, u), tile, _build.stream_ptr(x.device),
            ),
            "fused_mrf int8 prologue",
        )
    return h


fused_mrf.launches = 0
fused_mrf.int8_launches = 0
fused_mrf.conv_launches = 0
fused_mrf.int8_conv_launches = 0
fused_mrf.tf32_conv_launches = 0
fused_mrf.int8_dynamic_conv_launches = 0
fused_mrf.plain_calls = 0
