"""Analytic FLOP counts, H100 peaks and roofline bounds (counterpart of
``viettts_tpu/utils/flops.py``).

A profiler sees kernels, not the work a model needs, and the hand-written
kernels report no FLOPs at all, so the port counts multiply-accumulates
from the model configs (1 MAC = 2 FLOPs) and reports achieved FLOP/s and
model FLOPs utilization (MFU) against the card's dense peaks.

* ``duration_flops``, ``acoustic_decode_flops``, ``generator_flops`` and
  ``pipeline_flops`` are the JAX package's counts, integer for integer.
  Element-wise work (activations, norms, residual adds) is left out.
* ``generator_issued_flops`` counts what the port's vocoder kernels issue
  instead: the tiles that ``mma_conv_kernel`` (``csrc/mrf_common.cuh``)
  runs for each ConvTranspose prologue and the MRF convs of the stages
  that the fused pipeline (``csrc/mrf_fused.cuh``) does not take, their
  padding included; the fused pipeline's 64-row blocks over every tile's
  window, its halo recompute included (``fused_issued_macs``); the per-conv
  wgmma pipeline's tiles (``csrc/mrf_conv_wgmma.cuh``, the stages its
  router takes on each route: ``ops/mrf.py::conv_issued_macs`` over the C
  plan's tiles); and
  the conv_post epilogue's rows and channel chunks.  The tile table, the
  chunk widths and the tile picker's constants are read from the CUDA
  sources, so the count follows the kernels; the fused plan is
  ``ops/mrf.py``'s, which the tests hold to its source; the wgmma plan is
  the C header's own, through the plan library.
* ``device_peaks`` gives the dense peaks of the card it finds (H100 SXM and
  PCIe, NVIDIA's data sheets) and raises on any other: a utilization
  against some other card's peak would be a wrong number.
* ``mfu_report`` always names its utilization ``mfu`` and says in
  ``mfu_peak`` which peak it divides by: the route's compute (bf16; TF32
  for the float32 route, whose 3xTF32 dots run on the TF32 tensor cores;
  int8).
* ``parameter_counts``: the serving models' parameters at a config's
  widths, which the benchmark programs (``viettts_tpu_torch/bench``)
  hold their seeded models to.
* The training-step counts and the kernels' roofline bounds of
  ``chip_smoke.py`` (``duration_step_flop``, ``acoustic_step_flop``,
  ``gan_step_flop``, ``ar_decode_bound``, ``mrf_bound``).
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"


class Peaks(NamedTuple):
    """Dense peaks of one card: FLOP/s (int8: OP/s) and HBM bytes/s."""

    name: str
    bf16: float
    tf32: float
    fp32: float  # outside the tensor cores
    int8: float
    fp64_tensor: float
    hbm_bytes_per_s: float
    sm_count: int


# NVIDIA H100 data sheets, dense (half the "with sparsity" figures)
H100_SXM = Peaks("H100 SXM", 989e12, 495e12, 67e12, 1979e12, 67e12, 3.35e12, 132)
H100_PCIE = Peaks("H100 PCIe", 756e12, 378e12, 51e12, 1513e12, 51e12, 2.0e12, 114)

# the peak (and the MMA traits) each vocoder route's compute runs on
ROUTE_PEAK = {"bf16": "bf16", "bfloat16": "bf16", "float32": "tf32", "f32": "tf32", "int8": "int8"}


def peaks_for_name(name: str) -> Peaks:
    """The peaks of a card named as ``torch.cuda.get_device_name`` names it
    ("NVIDIA H100 80GB HBM3" is the SXM part); raises on any other card."""
    n = name.lower()
    if "h100" in n and "pcie" in n:
        return H100_PCIE
    if "h100" in n and ("hbm3" in n or "sxm" in n):
        return H100_SXM
    raise ValueError(f"no peaks known for {name!r} (known: NVIDIA H100 SXM, NVIDIA H100 PCIe)")


def device_peaks(device=None) -> Peaks:
    """The peaks of the CUDA card ``device`` (default: the current one)."""
    import torch

    return peaks_for_name(torch.cuda.get_device_name(device))


# ---------------------------------------------------------------------------
# The JAX package's counts.
# ---------------------------------------------------------------------------


def _conv1d(L, c_in, c_out, k, batch=1):
    return 2 * batch * L * c_in * c_out * k


def _dense(n, d_in, d_out, batch=1):
    return 2 * batch * n * d_in * d_out


def _lstm_steps(n, d_in, hidden, batch=1):
    # 4 gates, input + recurrent matmuls per step
    return 2 * batch * n * 4 * hidden * (d_in + hidden)


def _encoder_flops(n_tokens, dim, batch=1):
    """TokenEncoder: 3 x Conv1D(k=3) + bi-LSTM (hidden=dim each way); the
    embedding lookup is a gather."""
    f = 3 * _conv1d(n_tokens, dim, dim, 3, batch)
    f += 2 * _lstm_steps(n_tokens, dim, dim, batch)
    return f


def duration_flops(cfg, n_tokens, batch=1):
    """DurationModel: encoder + Dense(lstm_dim) + Dense(1)."""
    d = cfg.duration.lstm_dim
    f = _encoder_flops(n_tokens, d, batch)
    f += _dense(n_tokens, 2 * d, d, batch)
    f += _dense(n_tokens, d, 1, batch)
    return f


def acoustic_decode_flops(cfg, n_tokens, n_frames, batch=1):
    """AcousticModel.inference: encoder, Gaussian upsampling, the per-frame
    AR decode (prenet, 2 skip-connected LSTMs, mel projection), postnet."""
    a = cfg.acoustic
    enc_out = 2 * a.encoder_dim
    f = _encoder_flops(n_tokens, a.encoder_dim, batch)
    # upsampling attention: weights [L, T] plus context einsum [L,T]x[T,D]
    f += 2 * batch * n_frames * n_tokens * (1 + enc_out)
    f += _dense(n_frames, a.mel_dim, a.prenet_dim, batch)
    f += _dense(n_frames, a.prenet_dim, a.prenet_dim, batch)
    # decoder LSTMs: layer 1 eats [prenet, cond], layer 2 [h1, cond] (skip)
    f += _lstm_steps(n_frames, a.prenet_dim + enc_out, a.decoder_dim, batch)
    f += _lstm_steps(n_frames, a.decoder_dim + enc_out, a.decoder_dim, batch)
    f += _dense(n_frames, a.decoder_dim + enc_out, a.mel_dim, batch)
    # postnet: mel->P, 3 x P->P, P->mel, k=5
    f += _conv1d(n_frames, a.mel_dim, a.postnet_dim, 5, batch)
    f += 3 * _conv1d(n_frames, a.postnet_dim, a.postnet_dim, 5, batch)
    f += _conv1d(n_frames, a.postnet_dim, a.mel_dim, 5, batch)
    return f


def _hifigan(cfg):
    return cfg if hasattr(cfg, "upsample_rates") else cfg.hifigan


def generator_flops(cfg, n_frames, batch=1):
    """HiFi-GAN generator: conv_pre, per stage the ConvTranspose and the MRF
    convs, conv_post; either resblock variant."""
    h = _hifigan(cfg)
    C0 = h.upsample_initial_channel
    L = n_frames
    f = _conv1d(L, h.mel_dim, C0, 7, batch)
    c_in = C0
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        c_out = C0 // (2 ** (i + 1))
        L *= u
        # each output sample of the ConvTranspose sees ~k/u taps
        f += 2 * batch * L * c_in * c_out * (k / u)
        convs_per_dil = 2 if h.resblock == "1" else 1
        for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
            f += len(rd) * convs_per_dil * _conv1d(L, c_out, c_out, rk, batch)
        c_in = c_out
    f += _conv1d(L, c_in, 1, 7, batch)
    return int(f)


def pipeline_flops(cfg, n_tokens, n_frames, batch=1):
    """Whole synthesis pipeline (duration -> acoustic decode -> vocoder)."""
    return (
        duration_flops(cfg, n_tokens, batch)
        + acoustic_decode_flops(cfg, n_tokens, n_frames, batch)
        + generator_flops(cfg, n_frames, batch)
    )


# ---------------------------------------------------------------------------
# Parameter counts of the three serving models (what a benchmark checks
# its seeded models against: the widths of the config it claims).
# ---------------------------------------------------------------------------


def _lstm_params(d_in, hidden):
    return 4 * hidden * (d_in + hidden + 1)  # w_i, w_h and b, haiku's fused gates


def _encoder_params(vocab, dim):
    """Embedding, 3 x (Conv1D k=3 + BatchNorm scale and bias), bi-LSTM."""
    return vocab * dim + 3 * (3 * dim * dim + dim + 2 * dim) + 2 * _lstm_params(dim, dim)


def parameter_counts(cfg) -> Dict[str, int]:
    """Trainable parameters of the duration model, the acoustic model and
    the (unnormalized) generator at ``cfg``'s widths: ``{"duration",
    "acoustic", "generator"}``."""
    d, a, h = cfg.duration, cfg.acoustic, _hifigan(cfg)
    duration = _encoder_params(d.vocab_size, d.lstm_dim) + 2 * d.lstm_dim * d.lstm_dim + d.lstm_dim + d.lstm_dim + 1
    C, P, H, D, Q = 2 * a.encoder_dim, a.prenet_dim, a.decoder_dim, a.mel_dim, a.postnet_dim
    acoustic = (_encoder_params(a.vocab_size, a.encoder_dim) + _lstm_params(C + P, H) + _lstm_params(C + P + H, H)
                + D * P + P * P + 2 * H * D + D
                + 5 * (D * Q + 3 * Q * Q + Q * D) + 4 * Q + D + 4 * 2 * Q)
    C0 = h.upsample_initial_channel
    generator = 7 * h.mel_dim * C0 + C0
    convs_per_dil = 2 if h.resblock == "1" else 1
    for i, k in enumerate(h.upsample_kernel_sizes):
        ch = C0 // 2 ** (i + 1)
        generator += 2 * ch * ch * k + ch
        generator += sum(len(rd) * convs_per_dil * (rk * ch * ch + ch)
                         for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
    generator += 7 * (C0 // 2 ** len(h.upsample_kernel_sizes)) + 1
    return {"duration": duration, "acoustic": acoustic, "generator": generator}


# ---------------------------------------------------------------------------
# What the vocoder kernels issue.
# ---------------------------------------------------------------------------


class _Tile(NamedTuple):
    bm: int
    bn: int
    warps: int


class KernelPlan(NamedTuple):
    """The launch constants of ``csrc/``'s conv pipeline."""

    tiles: Tuple[_Tile, ...]  # TILES[] of mrf_common.cuh
    warps_per_sm: int  # pick_tile's target: this many warps on every SM
    narrow_bn: int  # pick_tile skips tiles wider than this where C_out fits it
    kc: Dict[str, int]  # input-channel chunk of each route's MMA traits
    bf16_narrow: Tuple[int, Dict[int, Tuple[int, int, int]]]  # (C_in bound, {tile: (KC, BM, BN)})
    int8_narrow: Tuple[int, int, Tuple[int, int, int]]  # (C_in bound, tile, (KC, BM, BN))
    post_rows: int  # conv_post: output rows per block
    post_chunk: int  # conv_post: input channels per chunk
    fused_block: int  # the fused pipeline's wgmma block rows (mrf_fused.cuh)


def _find(pattern: str, text: str, what: str) -> re.Match:
    m = re.search(pattern, text, re.S)
    if m is None:
        raise ValueError(f"the kernel sources no longer hold {what} (pattern {pattern!r})")
    return m


@functools.lru_cache(maxsize=1)
def kernel_plan() -> KernelPlan:
    """The tile table, chunk widths and picker constants, read from the
    CUDA sources that the kernels are built from."""
    common = (CSRC / "mrf_common.cuh").read_text()
    float_cu = (CSRC / "mrf.cu").read_text()
    int8_cu = (CSRC / "mrf_int8.cu").read_text()
    body = _find(r"constexpr Tile TILES\[\] = \{(.*?)\};", common, "the tile table").group(1)
    tiles = tuple(_Tile(*map(int, t)) for t in re.findall(r"\{(\d+),\s*(\d+),\s*(\d+)\}", body))
    warps = int(_find(r"const long long want = (\d+)LL \* sm_count\(\);", common, "pick_tile's target").group(1))
    bn_rule = _find(r"if \(tl\.bn > (\d+) && C_out <= (\d+)\) continue;", common, "pick_tile's narrow rule")
    if bn_rule.group(1) != bn_rule.group(2):
        raise ValueError(f"pick_tile's narrow rule changed: {bn_rule.group(0)}")

    def traits_kc(name):
        block = _find(rf"struct {name} \{{(.*?)\n}};", common, f"struct {name}").group(1)
        return int(_find(r"static constexpr int KC = (\d+);", block, f"{name}::KC").group(1))

    narrow = _find(r"if \(a\.C_in <= (\d+)\) switch \(tile\) \{(.*?)\}", float_cu, "the bf16 narrow-chunk switch")
    cases = {int(t): (int(kc), int(bm), int(bn)) for t, kc, bm, bn in re.findall(
        r"case (\d+): return launch_mma_conv<Bf16Mma<(\d+)>, (\d+), (\d+),", narrow.group(2))}
    i8 = _find(r"if \(a\.C_in <= (\d+) && tile == (\d+)\) return launch_mma_conv<Int8Mma<(\d+)>, (\d+), (\d+),",
               int8_cu, "the int8 narrow-chunk case")
    kc = {
        "bf16": int(_find(r"return launch_tile<Bf16Mma<(\d+)>>", float_cu, "the bf16 chunk").group(1)),
        "tf32": traits_kc("Tf32Mma"),
        "int8": int(_find(r"return launch_tile<Int8Mma<(\d+)>>", int8_cu, "the int8 chunk").group(1)),
        "fp64": traits_kc("F64Mma"),
    }
    return KernelPlan(
        tiles=tiles,
        warps_per_sm=warps,
        narrow_bn=int(bn_rule.group(1)),
        kc=kc,
        bf16_narrow=(int(narrow.group(1)), cases),
        int8_narrow=(int(i8.group(1)), int(i8.group(2)), (int(i8.group(3)), int(i8.group(4)), int(i8.group(5)))),
        post_rows=int(_find(r"constexpr int PT = (\d+);", float_cu, "conv_post's rows per block").group(1)),
        post_chunk=int(_find(r"constexpr int PK = (\d+);", float_cu, "conv_post's channel chunk").group(1)),
        fused_block=int(_find(r"constexpr int FUSED_BLOCK = (\d+);", (CSRC / "mrf_fused.cuh").read_text(),
                              "the fused pipeline's block rows").group(1)),
    )


def pick_tile(plan: KernelPlan, B: int, L: int, C_out: int, sm_count: int) -> int:
    """``pick_tile`` of ``csrc/mrf_common.cuh``: the first tile that puts
    ``warps_per_sm`` warps on every SM (the last one otherwise)."""
    want = plan.warps_per_sm * sm_count
    for i, t in enumerate(plan.tiles):
        if t.bn > plan.narrow_bn and C_out <= plan.narrow_bn:
            continue
        if -(-L // t.bm) * -(-C_out // t.bn) * B * t.warps >= want:
            return i
    return len(plan.tiles) - 1


def _conv_tile(plan: KernelPlan, kind: str, C_in: int, tile: int) -> Tuple[int, int, int]:
    """(KC, BM, BN) of a launch: the route's chunk and the tile's shape,
    with the narrow-chunk instantiations of ``launch_conv`` (bf16) and
    ``launch_int8``."""
    t = plan.tiles[tile]
    if kind == "bf16":
        bound, cases = plan.bf16_narrow
        if C_in <= bound and tile in cases:
            return cases[tile]
    elif kind == "int8":
        bound, narrow_tile, shape = plan.int8_narrow
        if C_in <= bound and tile == narrow_tile:
            return shape
    return plan.kc[kind], t.bm, t.bn


def _issued_macs(plan, kind, B, L_rows, C_in, C_out, taps, phases, sm_count) -> int:
    """MACs ``mma_conv_kernel`` issues for one conv: every block's BM x BN
    outputs over the phase's taps and every KC-wide input chunk, padding
    included (the taps of the ``phases`` output phases sum to ``taps``)."""
    tile = pick_tile(plan, B * phases, L_rows, C_out, sm_count)
    kc, bm, bn = _conv_tile(plan, kind, C_in, tile)
    return -(-L_rows // bm) * bm * -(-C_out // bn) * bn * B * taps * -(-C_in // kc) * kc


def fused_issued_macs(launch, C, kernel_sizes, dilations, resblock2, batch, block=64) -> int:
    """MACs the fused pipeline issues for a stage's MRF convs planned as
    ``launch`` (``ops/mrf.py::plan_fused``): every tile computes, for each
    resblock, ``fused_block_rows`` rows (each conv's output range in whole
    ``block``-row blocks, over its window), taps x C x C MACs a row."""
    from viettts_tpu_torch.ops.mrf import fused_block_rows

    return sum(batch * launch.tiles_per_row * fused_block_rows(launch.win, launch.halo, k, d, resblock2, block)
               * C * C * k for k, d in zip(kernel_sizes, dilations))


def mrf_issued_flops(h, B, L, C, route, sm_count=H100_SXM.sm_count, int8_static=False) -> int:
    """2 x the MACs the port issues for one stage's MRF convs (B rows of L
    steps, C channels) on ``route``: the fused pipeline's blocks where
    ``plan_fused`` takes the stage, the per-conv wgmma pipeline's tiles
    where its C plan does on the route (bf16, tf32, static or dynamic
    int8), else ``mma_conv_kernel``'s tiles."""
    from viettts_tpu_torch.ops.mrf import conv_issued_macs, conv_route_name, conv_takes, fused_route_name, plan_fused

    resblock2 = h.resblock != "1"
    ks, ds = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    fused = fused_route_name(route, int8_static)
    plan = kernel_plan()
    launch = None if fused is None else plan_fused(fused, C, ks, ds, resblock2, B, L, sm_count)
    if launch is not None:
        return 2 * fused_issued_macs(launch, C, ks, ds, resblock2, B, plan.fused_block)
    conv_route = conv_route_name(route, int8_static)
    if conv_takes(conv_route, B, L, C):
        return 2 * conv_issued_macs(B, L, C, ks, ds, resblock2, sm_count, conv_route)
    convs = 1 if resblock2 else 2
    return 2 * sum(len(rd) * convs * _issued_macs(plan, ROUTE_PEAK[route], B, L, C, C, rk, 1, sm_count)
                   for rk, rd in zip(ks, ds))


def generator_issued_flops(cfg, n_frames, batch=1, route="bfloat16", sm_count=H100_SXM.sm_count,
                           int8_static=False) -> int:
    """2 x the MACs the port's serving generator issues on ``route``
    (``bfloat16``, ``float32`` or ``int8``, with calibrated scales where
    ``int8_static``) for a mel of ``n_frames``: conv_pre (a torch conv,
    counted as needed), then per stage the ConvTranspose prologue (bf16 or
    3xTF32 tiles, float64 tiles on the int8 route) and the MRF convs: on
    the fused pipeline where it takes the stage (``fused_issued_macs``),
    the per-conv wgmma pipeline where its plan does (``conv_issued_macs``),
    else bf16, 3xTF32 or int8 tiles as ``mma_conv_kernel`` tiles them, for
    a card of ``sm_count`` SMs; and conv_post's blocks.  3xTF32 runs three
    tensor-core products per MAC counted here.  Equals ``generator_flops``
    where the fused pipeline takes no stage and every dimension divides
    its tile."""
    h = _hifigan(cfg)
    plan = kernel_plan()
    kind = ROUTE_PEAK[route]
    C0 = h.upsample_initial_channel
    L = n_frames
    macs = L * h.mel_dim * C0 * 7 * batch
    c_in = C0
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        C = C0 // 2 ** (i + 1)
        macs += _issued_macs(plan, "fp64" if kind == "int8" else kind, batch, L, c_in, C, k, u, sm_count)
        L *= u
        macs += mrf_issued_flops(h, batch, L, C, route, sm_count, int8_static) // 2
        c_in = C
    rows, chunk = plan.post_rows, plan.post_chunk
    macs += -(-L // rows) * rows * batch * 7 * -(-c_in // chunk) * chunk
    return 2 * macs


# ---------------------------------------------------------------------------
# Utilization and roofline.
# ---------------------------------------------------------------------------


def mfu_report(flops: float, seconds: float, device=None, compute_dtype: str = "bf16",
               peaks: Optional[Peaks] = None) -> dict:
    """Achieved TFLOP/s and utilization of one measured stage: ``mfu`` is
    the achieved rate over the peak of the route's compute, named in
    ``mfu_peak``, whatever the dtype; ``nominal_flops_over_*`` are ratios
    to other peaks (which may exceed 1)."""
    peaks = peaks or device_peaks(device)
    key = ROUTE_PEAK[compute_dtype]
    achieved = flops / max(seconds, 1e-12)
    return {
        "flops": int(flops),
        "tflops_per_sec": achieved / 1e12,
        "mfu": achieved / getattr(peaks, key),
        "mfu_peak": key,
        "nominal_flops_over_f32_peak": achieved / peaks.fp32,
        "nominal_flops_over_bf16_peak": achieved / peaks.bf16,
        "card": peaks.name,
    }


def roofline(bytes_: float, ops_seconds: float, peaks: Peaks) -> Tuple[float, str]:
    """(bound ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations' time at their peaks (seconds, summed by type)."""
    t_bytes = bytes_ / peaks.hbm_bytes_per_s
    return max(t_bytes, ops_seconds) * 1e3, "operations" if ops_seconds >= t_bytes else "bytes"


def ar_decode_bound(B, L, H, P, D, peaks: Peaks) -> Tuple[float, str]:
    """K1's roofline: 2 FLOP per weight per batch row per frame at the
    float32 peak; bytes: every weight, both gate tensors, both keep masks
    and the mel read or written once."""
    weights = D * P + P * P + (P + H) * 4 * H + (P + 2 * H) * 4 * H + 2 * H * D + D
    flop = 2.0 * (weights - D) * B * L
    bytes_ = 4 * weights + 2 * 4 * B * L * 4 * H + 2 * L * B * P + 4 * B * L * D
    return roofline(bytes_, flop / peaks.fp32, peaks)


def bilstm_bound(B, T, H, peaks: Peaks) -> Tuple[float, str]:
    """The bi-LSTM kernel's roofline (``csrc/lstm.cu``, the recurrence
    alone: the input projections are the caller's matmuls): 2 FLOP per
    w_h weight per row per step, both directions, at the float32 peak;
    bytes: both w_h, both projections read and the output written once."""
    flop = 2.0 * 2 * B * T * H * 4 * H
    bytes_ = 4 * (2 * H * 4 * H + 2 * B * T * 4 * H + B * T * 2 * H)
    return roofline(bytes_, flop / peaks.fp32, peaks)


def stage_shapes(h, frames) -> List[Tuple[int, int, int, int, int, bool]]:
    """(C_in, C, k_up, u, L_in, post) of each generator stage for a mel of
    ``frames`` frames."""
    out, L = [], frames
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        c_in = h.upsample_initial_channel // 2 ** i
        out.append((c_in, c_in // 2, k, u, L, i == len(h.upsample_rates) - 1))
        L *= u
    return out


def mrf_flop(h, B, L, C, resblock2) -> float:
    """FLOP of a stage's MRF convs: 2 * B * L * C^2 * (taps summed over
    its convs)."""
    taps = sum(len(d) * k * (1 if resblock2 else 2) for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
    return 2.0 * B * L * C * C * taps


def mrf_bound(h, B, T, route, peaks: Peaks) -> Tuple[float, str]:
    """Roofline of the ResBlock1 generator stages for a mel of T frames at
    batch B: each stage's input, weights and output moved once; its
    ConvTranspose prologue, MRF convs and (last stage) conv_post as
    multiply-adds.  bfloat16: bf16 storage, every product on the bf16
    tensor cores.  float32: 3xTF32, three TF32 products per product.  int8:
    bf16 storage and int8 MRF weights, the MRF products at the int8 rate,
    the float64 prologue (FP64 tensor cores) and the conv_post epilogue
    (float32) at their peaks."""
    esize = {"bfloat16": 2, "float32": 4, "int8": 2}[route]
    bytes_, secs = 0.0, 0.0
    for C_in, C, k_u, u, L_in, post in stage_shapes(h, T):
        L = L_in * u
        mrf_w = sum(len(d) * 2 * (k * C * C + C) for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
        pro_w, post_w = k_u * C_in * C + C, (7 * C + 1) if post else 0
        bytes_ += esize * (B * L_in * C_in + B * L * (1 if post else C))
        bytes_ += (1 if route == "int8" else esize) * mrf_w + esize * (pro_w + post_w)
        pro_flop = 2.0 * B * L * C * C_in * k_u / u
        mrf = mrf_flop(h, B, L, C, False)
        post_flop = 2.0 * B * L * 7 * C if post else 0.0
        if route == "bfloat16":
            secs += (pro_flop + mrf + post_flop) / peaks.bf16
        elif route == "float32":
            secs += 3 * (pro_flop + mrf + post_flop) / peaks.tf32
        else:
            secs += mrf / peaks.int8 + pro_flop / peaks.fp64_tensor + post_flop / peaks.fp32
    return roofline(bytes_, secs, peaks)


def mrf_stage_bound(h, B, L, C, route, peaks: Peaks) -> Tuple[float, str]:
    """Roofline of one ResBlock1 stage's MRF convs alone (B rows of L
    steps, C channels): the stage input read and its output written once in
    the storage dtype (bf16; float32 on the float32 route), the MRF weights
    read once (int8 codes on the int8 route); the products at the route's
    peak (3xTF32: three TF32 products a product)."""
    esize = {"bfloat16": 2, "float32": 4, "int8": 2}[route]
    mrf_w = sum(len(d) * 2 * (k * C * C + C) for k, d in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
    bytes_ = 2 * esize * B * L * C + (1 if route == "int8" else esize) * mrf_w
    flop = mrf_flop(h, B, L, C, False)
    peak = {"bfloat16": peaks.bf16, "float32": peaks.tf32 / 3, "int8": peaks.int8}[route]
    return roofline(bytes_, flop / peak, peaks)


# ---------------------------------------------------------------------------
# Training steps (forward + backward, the backward counted as twice the
# forward).
# ---------------------------------------------------------------------------


def duration_step_flop(cfg) -> float:
    """2 x multiply-adds of one duration step from the shapes: encoder
    convs, both LSTM directions (input and recurrent projections), the two
    dense heads."""
    B, T, C = cfg.train.batch_size, cfg.data.max_phoneme_seq_len, cfg.duration.lstm_dim
    fwd = 3 * 2 * B * T * 3 * C * C + 2 * 2 * (2 * B * T * C * 4 * C) + 2 * B * T * (2 * C * C + C)
    return 3.0 * fwd


def acoustic_step_flop(cfg) -> float:
    """As ``duration_step_flop`` for the acoustic step: the log-mel DFT and
    filterbank (no backward), encoder, Gaussian upsampling, prenet, both
    decoder layers' input gates, the 3 recurrent products a frame, the
    projection and the 5 postnet convs."""
    B, Tt = cfg.train.batch_size, cfg.data.max_phoneme_seq_len
    d, a = cfg.dsp, cfg.acoustic
    L = cfg.data.max_wave_len // d.hop_length
    C, P, H, D, Q = a.encoder_dim, a.prenet_dim, a.decoder_dim, a.mel_dim, a.postnet_dim
    nf = d.n_fft // 2 + 1
    mel = 2 * B * L * d.n_fft * nf * 2 + 2 * B * L * nf * D
    enc = 3 * 2 * B * Tt * 3 * C * C + 2 * 2 * (2 * B * Tt * C * 4 * C)
    dec = (2 * B * L * Tt * 2 * C + 2 * B * L * (D * P + P * P) + 2 * 2 * B * L * (2 * C + P) * 4 * H
           + L * 3 * 2 * B * H * 4 * H + 2 * B * L * 2 * H * D)
    post = 2 * B * L * 5 * (D * Q + 3 * Q * Q + Q * D)
    return float(mel) + 3.0 * (enc + dec + post)


def gan_step_flop(cfg) -> float:
    """2 x multiply-adds of one GAN step from the shapes: the generator
    (conv_pre, each stage's ConvTranspose and MRF convs, conv_post), the
    MPD and MSD convs and the log-mel DFT and filterbank, per waveform.
    The generator runs forward and backward (3x its forward); the
    discriminators forward and backward on both waveforms in the
    discriminator step (3x each), then forward on the real one (1x) and
    forward and backward to their input, weights frozen, on the generated
    one (2x); the mel of the real audio once, of the generated one forward
    and backward to the input (2x)."""
    h, d = cfg.hifigan, cfg.dsp
    B, S = cfg.train.batch_size, h.segment_size
    L, C = S // d.hop_length, h.upsample_initial_channel
    mel = L * (d.n_fft * (d.n_fft // 2 + 1) * 2 + (d.n_fft // 2 + 1) * d.mel_dim)
    gen = L * d.mel_dim * C * 7
    convs = 2 if h.resblock == "1" else 1
    for u, k in zip(h.upsample_rates, h.upsample_kernel_sizes):
        gen += L * C * (C // 2) * k  # ConvTranspose: each input sample meets k taps
        L, C = L * u, C // 2
        gen += sum(L * C * C * rk * len(rd) * convs for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes))
    gen += L * C * 7
    disc = 0
    bc = h.mpd_base_channels
    for p in h.mpd_periods:
        H, chans = -(-S // p), (1, bc, 4 * bc, 16 * bc, 32 * bc)
        for c_in, c_out in zip(chans[:-1], chans[1:]):
            H = (H - 1) // 3 + 1
            disc += H * p * c_in * c_out * 5
        disc += H * p * (32 * bc * 32 * bc * 5 + 32 * bc * 3)
    T, bc = S, h.msd_base_channels
    for i in range(h.msd_scales):
        T = T if i == 0 else T // 2 + 1
        t, c_in = T, 1
        for f, k, st, g, pad in ((1, 15, 1, 1, 7), (1, 41, 2, 4, 20), (2, 41, 2, 16, 20), (4, 41, 4, 16, 20),
                                 (8, 41, 4, 16, 20), (8, 41, 1, 16, 20), (8, 5, 1, 1, 2)):
            t = (t + 2 * pad - k) // st + 1
            disc += t * f * bc * (c_in // g) * k
            c_in = f * bc
        disc += t * c_in * 3
    return 2.0 * B * (3 * gen + (3 + 1) * disc + (3 + 2) * disc + mel + 2 * mel)
