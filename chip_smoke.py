#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

1. Environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the nvcc build of the port's kernels from
   ``viettts_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch twin on the card, at the shapes
   the main path gives it, TF32 off: K1 ``ar_decode`` (H=512, P=256, D=80;
   B in {1, 4, 16}; 512 and 300 frames; dropout masks on; two launches
   must give the same bits), K2 ``fused_mrf``
   (the four default generator stages, B=2, 128 and 100 mel frames,
   ConvTranspose prologue on, conv_post epilogue on the last stage,
   ResBlock1 and ResBlock2, float32 and bfloat16 storage) and K3
   ``fused_mrf(quantize_int8=True)`` (the same stages in bfloat16 storage
   at B=2 and at the main path's B=1, static and dynamic activation scales,
   with the int8 codes that the two sides' float64 prologue sums flip, and
   per stage the prologue alone, the int8 MRF convs alone and bf16 K2 on
   the same inputs), with both times and each kernel's roofline bound
   (``bound_ms``: the larger of its bytes over the HBM rate and its
   operations over the dense peak of their type, H100 SXM data sheet).
3. The main paths at the full default width (``Config()``) on seeded
   random weights written as native checkpoints, each with the launch
   counters zeroed just before it and read just after (every kernel of the
   path must have launched, no plain twin may have run):
   a. the port's CLI on one sentence, then ``Synthesizer.synthesize`` and
      ``synthesize_batch`` on 4 texts, on the default bf16 vocoder route and
      on the ``--quality`` float32 route (K1, K2);
   b. the int8 route (K1, K2's prologue and epilogue, K3): the CLI with
      ``--stream`` (dynamic scales), ``Synthesizer.warmup()`` (calibration),
      ``synthesize``, ``synthesize_batch`` and ``stream`` (time to first
      audio: the median of 3 streams), then the port's
      server (``viettts_tpu_torch.serve`` with ``--warmup
      --int8-probe-every 1``) answering /tts twice, /tts/stream once and
      /stats, which must carry ``int8_max_clip_fraction``.
   The outputs must be finite, in [-1, 1] and 256 samples per mel frame,
   and the card must agree with the CPU (plain twins): a float32 synthesis,
   and the int8 vocoder, with the card's scales, on the same mel, which
   must also stay within int8 quantization error of the float32 vocoder.
4. The training slice: a synthetic aligned corpus of 96 utterances, then
   ``viettts_tpu_torch.train.duration.train`` (20 steps, B=64, 256 tokens,
   validation and a checkpoint every 10) and ``.acoustic.train`` (6 steps,
   B=64, 768 frames) at the default width on the card, each with ms/step
   (first step, then the median), first and last loss (finite), peak
   device memory, and FLOPs per step with their bound at the float32
   peak; both checkpoints read back by the port's ``load_variables`` into a
   Synthesizer with the seeded vocoder, which synthesizes on the card (K1,
   K2, counted); and one step of each trainer at a small config on the card
   against the CPU, TF32 off, within 1e-4.
5. The vocoder half of the training recipe on the card, on the same
   corpus: ``tools.zero_silence_segments``, then
   ``viettts_tpu_torch.train.hifigan.train`` at the default width
   (``HifiGanConfig()``: generator 512 channels, MPD periods 2/3/5/7/11 at
   base 32, MSD 3 scales at base 128; segment 8192, B=64) for 6 steps with
   an in-loop checkpoint every 3, each step's ms, losses, peak memory and
   FLOPs with their bound; ``tools.gta.generate_gta`` on the acoustic
   checkpoint of phase 4; 2 more GAN steps in GTA mode, resuming that
   checkpoint in a second directory; one GAN step at a small config on the
   card against the CPU (losses and spectral ``u`` within 1e-4, TF32 off).
   The GAN-trained vocoder then serves ``SENTENCE`` with phase 4's
   duration and acoustic checkpoints on the float32, bf16 and int8 routes
   (int8 calibrated by ``warmup()``), counted: K1, K2 and K3 must launch
   and no plain twin may run; bf16 and int8 are logged against float32 on
   the same mel (rel-RMS, max abs; a few-step generator, not trained
   weights).
6. A JSON line of per-kernel results, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero.  Without a CUDA device
it exits 1 before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

SENTENCE = "xin chào các bạn, hôm nay trời đẹp quá"
STREAM_TEXT = (
    "hôm nay trời nắng đẹp, chúng ta cùng nhau đi dạo quanh bờ hồ. "
    "ngắm hàng cây xanh và nghe tiếng chim hót líu lo trên cao. "
    "chiều về, cả nhà quây quần bên mâm cơm, kể cho nhau nghe chuyện một ngày"
)
BATCH_TEXTS = [
    "một hai ba",
    "hôm qua em tới trường, mẹ dắt tay từng bước",
    "số điện thoại là không chín tám bảy sáu năm bốn ba hai một",
    "tuyệt vời quá!",
]
K1_ATOL = 1e-4
K1_CASES = ((1, 512), (4, 512), (16, 512), (1, 300), (4, 300), (16, 300))
K2_F32 = dict(rtol=1e-5, atol=1e-4)
K2_BF16_REL = 0.02  # of max(|reference|, 1), the bar of tests/test_mrf.py
K2_BF16_DOTS_REL_RMS = 1e-3  # bf16 kernel vs the twin with bf16-rounded dot operands
MAIN_PATH_FRAMES = 158  # mel frames of SENTENCE at B=1 on the main path (2.53 s of audio)
# dense tensor-core peaks of an H100 SXM at 700 W (NVIDIA data sheet): bf16,
# and TF32 for the float32 route, whose 3xTF32 dots issue 3 products per
# product counted
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 495.0}
# H100 SXM at 700 W (NVIDIA data sheet): float32 outside the tensor cores
# (K1, the conv_post epilogue) and the FP64 tensor cores (K3's prologue),
# both 67 TFLOP/s; dense int8 tensor cores (K3); HBM3 bytes per second
PEAK_F32_FLOPS, PEAK_INT8_OPS, HBM_BYTES_PER_S = 67e12, 1979e12, 3.35e12
K3_REL_RMS = 1e-3
K3_MAX_REL = 0.02  # of max(|reference|, 1)
INT8_ROUTE_REL_RMS = 5e-3  # card vs CPU int8 vocoder on the same mel
INT8_VS_F32_REL_RMS = 0.05  # int8 vs float32 generator, the bar of tests/test_mrf.py


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    with CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def roofline(bytes_, ops_seconds):
    """(bound ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations' time at their peaks (seconds, summed by type)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S
    return max(t_bytes, ops_seconds) * 1e3, "operations" if ops_seconds >= t_bytes else "bytes"


def ar_decode_bound(B, L, H, P, D):
    """K1's roofline: 2 FLOP per weight per batch row per frame at the
    float32 peak; bytes: every weight, both gate tensors, both keep masks
    and the mel read or written once."""
    weights = D * P + P * P + (P + H) * 4 * H + (P + 2 * H) * 4 * H + 2 * H * D + D
    flop = 2.0 * (weights - D) * B * L
    bytes_ = 4 * weights + 2 * 4 * B * L * 4 * H + 2 * L * B * P + 4 * B * L * D
    return roofline(bytes_, flop / PEAK_F32_FLOPS)


def seeded(rng, *shape, scale=1.0):
    import numpy as np

    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def check_ar_decode(dev, H=512, P=256, D=80, cases=K1_CASES):
    """K1 against its twin at each (B, frames) case, and against itself:
    two launches on the same inputs must give the same bits.  Returns the
    worst error and per-case times with the roofline bound."""
    import numpy as np
    import torch

    from viettts_tpu_torch.ops.ar_decoder import ar_decode, ar_decode_plain

    rng = np.random.default_rng(0)
    weights = [
        seeded(rng, D, P, scale=D ** -0.5), seeded(rng, P, P, scale=P ** -0.5),
        seeded(rng, P + H, 4 * H, scale=(P + H) ** -0.5),
        seeded(rng, P + 2 * H, 4 * H, scale=(P + 2 * H) ** -0.5),
        seeded(rng, 2 * H, D, scale=(2 * H) ** -0.5), seeded(rng, D, scale=0.1),
    ]
    weights = [torch.from_numpy(w).to(dev) for w in weights]
    worst, times = 0.0, {}
    for B, L in cases:
        g1c, g2c = (torch.from_numpy(seeded(rng, B, L, 4 * H, scale=0.5)).to(dev) for _ in range(2))
        keep1, keep2 = (torch.from_numpy(rng.random((L, B, P)) < 0.5).to(dev) for _ in range(2))
        args = (g1c, g2c, keep1, keep2, *weights, 2.0)
        got = ar_decode(*args)
        again = ar_decode(*args)
        want = ar_decode_plain(*args)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        log(f"K1 ar_decode B={B} L={L}: max|kernel - twin| = {err:.3e} (atol {K1_ATOL}); "
            f"two launches bitwise equal: {torch.equal(got, again)}")
        if not err <= K1_ATOL:
            raise AssertionError(f"ar_decode B={B} L={L} differs from its twin by {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"ar_decode B={B} L={L}: two launches on the same inputs differ")
        ms = time_ms(lambda: ar_decode(*args))
        plain_ms = time_ms(lambda: ar_decode_plain(*args), reps=2)
        bound_ms, bound_by = ar_decode_bound(B, L, H, P, D)
        times[(B, L)] = {"ms": ms, "plain_ms": plain_ms, "us_per_frame": 1e3 * ms / L,
                         "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
        log(f"K1 ar_decode B={B} L={L}: kernel {ms:.3f} ms ({1e3 * ms / L:.2f} us/frame), twin {plain_ms:.3f} ms; "
            f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.2f}% of bound")
    return worst, times


def stage_shapes(cfg, frames):
    """(C_in, C, k_up, u, L_in, post) of each generator stage for a mel of
    ``frames`` frames."""
    out, L = [], frames
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        c_in = cfg.upsample_initial_channel // 2 ** i
        out.append((c_in, c_in // 2, k, u, L, i == len(cfg.upsample_rates) - 1))
        L *= u
    return out


def stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, resblock2, dtype):
    import torch

    from viettts_tpu_torch.ops.mrf import prepare_mrf_weights

    def t(*shape, scale):
        return torch.from_numpy(seeded(rng, *shape, scale=scale)).to(dev)

    blocks = []
    for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
        n, s = len(dils), 0.5 / (k * C) ** 0.5
        w2 = None if resblock2 else t(n, k, C, C, scale=s)
        b2 = None if resblock2 else t(n, C, scale=0.05)
        blocks.append((t(n, k, C, C, scale=s), t(n, C, scale=0.05), w2, b2))
    ups = (t(k_u, C_in, C, scale=(k_u * C_in / u) ** -0.5), t(C, scale=0.05), u)
    pst = (t(7, C, 1, scale=(7 * C) ** -0.5), t(1, scale=0.05)) if post else None
    return prepare_mrf_weights(blocks, ups, pst, dtype)


def mrf_flop(cfg, B, L, C, resblock2):
    """FLOP of a stage's MRF convs: 2 * B * L * C^2 * (taps summed over
    its convs)."""
    taps = sum(len(d) * k * (1 if resblock2 else 2)
               for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
    return 2.0 * B * L * C * C * taps


def mrf_bound(cfg, B, T, route):
    """Roofline of the four ResBlock1 generator stages for a mel of T frames
    at batch B: each stage's input, weights and output moved once; its
    ConvTranspose prologue, 18 MRF convs and (last stage) conv_post as
    multiply-adds.  bfloat16: bf16 storage, every product on the dense bf16
    tensor cores (989 TFLOP/s).  float32: 3xTF32, three TF32 products per
    product (495 TFLOP/s).  int8: bf16 storage and int8 MRF weights, the MRF
    products at 1979 TOP/s, the float64 prologue (FP64 tensor cores) and the
    conv_post epilogue (float32) at 67 TFLOP/s."""
    esize = {"bfloat16": 2, "float32": 4, "int8": 2}[route]
    bytes_, secs = 0.0, 0.0
    for C_in, C, k_u, u, L_in, post in stage_shapes(cfg, T):
        L = L_in * u
        mrf_w = sum(len(d) * 2 * (k * C * C + C) for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
        pro_w, post_w = k_u * C_in * C + C, (7 * C + 1) if post else 0
        bytes_ += esize * (B * L_in * C_in + B * L * (1 if post else C))
        bytes_ += (1 if route == "int8" else esize) * mrf_w + esize * (pro_w + post_w)
        pro_flop = 2.0 * B * L * C * C_in * k_u / u
        mrf = mrf_flop(cfg, B, L, C, False)
        post_flop = 2.0 * B * L * 7 * C if post else 0.0
        if route == "bfloat16":
            secs += (pro_flop + mrf + post_flop) / (PEAK_TFLOPS["bfloat16"] * 1e12)
        elif route == "float32":
            secs += 3 * (pro_flop + mrf + post_flop) / (PEAK_TFLOPS["float32"] * 1e12)
        else:
            secs += mrf / PEAK_INT8_OPS + (pro_flop + post_flop) / PEAK_F32_FLOPS
    return roofline(bytes_, secs)


def check_fused_mrf(dev, cfg, cases=((2, 128), (2, 100), (1, MAIN_PATH_FRAMES)),
                    timed_cases=((2, 128), (1, MAIN_PATH_FRAMES))):
    """K2 against its twins at every stage of each (B, frames) case,
    ResBlock1 and ResBlock2, float32 and bfloat16; ResBlock1 stages timed
    at (2, 128) and at the main path's B=1 frame count."""
    import numpy as np
    import torch

    from viettts_tpu_torch.ops.mrf import fused_mrf, fused_mrf_plain

    rng = np.random.default_rng(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0, "bf16_dots_rel_rms": 0.0}
    # times[dtype][(B, T)] = per stage [kernel ms, twin ms, MRF-only kernel ms, MRF TFLOP/s]
    times = {torch.float32: {}, torch.bfloat16: {}}
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    for dtype in (torch.float32, torch.bfloat16):
        peak = PEAK_TFLOPS[str(dtype)[6:]]
        for resblock2 in (False, True):
            for B, T in cases:
                timed = not resblock2 and (B, T) in timed_cases
                for i, (C_in, C, k_u, u, L_in, post) in enumerate(stage_shapes(cfg, T)):
                    w, ups, pst = stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, resblock2, dtype)
                    x = torch.from_numpy(seeded(rng, B, L_in, C_in)).to(dev, dtype)
                    kw = dict(upsample=ups, post=pst, compute_dtype=dtype)
                    got = fused_mrf(x, w, ks, ds, **kw)
                    want = fused_mrf_plain(x, w, ks, ds, **kw)
                    if got.shape != want.shape or got.dtype != want.dtype:
                        raise AssertionError(f"fused_mrf stage {i}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
                    diff = (got.float() - want.float()).abs()
                    err = diff.max().item()
                    worst[dtype] = max(worst[dtype], err)
                    if dtype == torch.float32:
                        bound = K2_F32["atol"] + K2_F32["rtol"] * want.abs()
                        ok = bool((diff <= bound).all())
                        bar = f"rtol {K2_F32['rtol']} atol {K2_F32['atol']}"
                    else:
                        scale = max(want.float().abs().max().item(), 1.0)
                        rounded = fused_mrf_plain(x, w, ks, ds, bf16_dots=True, **kw)
                        rel = rel_rms(got.float(), rounded.float())
                        worst["bf16_dots_rel_rms"] = max(worst["bf16_dots_rel_rms"], rel)
                        ok = err <= K2_BF16_REL * scale and rel <= K2_BF16_DOTS_REL_RMS
                        bar = (f"atol {K2_BF16_REL * scale:.3g}; vs the bf16-operand twin rel-RMS {rel:.2e} "
                               f"(bar {K2_BF16_DOTS_REL_RMS}; the f32 twin is "
                               f"{rel_rms(want.float(), rounded.float()):.2e} from it)")
                    tag = (f"K2 fused_mrf {str(dtype)[6:]} resblock{'2' if resblock2 else '1'} "
                           f"stage {i} x=[{B},{L_in},{C_in}] -> [{B},{L_in * u},{1 if post else C}]")
                    log(f"{tag}: max|kernel - twin| = {err:.3e} ({bar})")
                    if not ok:
                        raise AssertionError(f"{tag} differs from its twin by {err}")
                    if timed:
                        ms = time_ms(lambda: fused_mrf(x, w, ks, ds, **kw))
                        plain_ms = time_ms(lambda: fused_mrf_plain(x, w, ks, ds, **kw))
                        # the MRF convs alone: the stage without prologue and epilogue
                        h = torch.from_numpy(seeded(rng, B, L_in * u, C)).to(dev, dtype)
                        mrf_ms = time_ms(lambda: fused_mrf(h, w, ks, ds, compute_dtype=dtype))
                        rate = mrf_flop(cfg, B, L_in * u, C, resblock2) / mrf_ms / 1e9
                        times[dtype].setdefault((B, T), []).append([ms, plain_ms, mrf_ms, rate])
                        log(f"{tag}: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms; MRF convs alone "
                            f"{mrf_ms:.3f} ms = {rate:.1f} TFLOP/s ({100 * rate / peak:.1f}% of the "
                            f"{peak:.0f} TFLOP/s dense {'bf16' if dtype == torch.bfloat16 else 'TF32'} peak)")
        for (B, T), rows in times[dtype].items():
            log(f"K2 fused_mrf {str(dtype)[6:]} B={B} {T} frames, 4 stages: kernel "
                f"{sum(r[0] for r in rows):.3f} ms, twin {sum(r[1] for r in rows):.3f} ms")
    return worst, times


def rel_rms(got, want):
    return ((got - want).square().mean().sqrt() / want.square().mean().sqrt().clamp_min(1e-30)).item()


def first_code_flips(x, ups, act):
    """int8 codes of the stage's first conv input that differ between K3's
    float64 prologue (FP64 tensor cores) and the twin's float64
    ConvTranspose: where kernel and twin can first part (the integer dots
    and the later float32 steps are the same on both sides)."""
    import torch
    from torch.nn import functional as F

    from viettts_tpu_torch.ops.mrf import conv_transpose_same, convt_f64, convt_weight_to_torch

    w_t, b_t, u = ups
    C = w_t.w.shape[2]
    h = convt_f64(x.float(), w_t, b_t, u)
    zero = torch.zeros(C, dtype=torch.float64, device=x.device)
    twin = conv_transpose_same(
        F.leaky_relu(x.float().transpose(1, 2), 0.1).double(), convt_weight_to_torch(w_t.w.float()).double(), zero, u
    ).float() + b_t.float()[None, :, None]
    twin = twin.transpose(1, 2)
    c127 = torch.tensor(127.0, device=x.device)

    def codes(t):
        y = F.leaky_relu(t, 0.1)
        if act is not None:
            return torch.round(torch.clamp(y * (c127 / act.clamp_min(1e-12)), -127.0, 127.0))
        a = y.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
        return torch.round(y * (c127 / a))

    return int((codes(h) != codes(twin)).sum().item())


def check_fused_mrf_int8(dev, cfg, cases=((2, 128), (2, 100), (1, MAIN_PATH_FRAMES)),
                         timed_cases=((2, 128), (1, MAIN_PATH_FRAMES))):
    """K3 against its twin at every stage of each (B, frames) case, ResBlock1
    and ResBlock2, static and dynamic scales, counting the first conv's int8
    codes that kernel and twin give differently.  ResBlock1 stages are timed
    at (2, 128) and at the main path's B=1 frame count: the stage (static
    and dynamic) and its twin, then the split (the float64 prologue alone;
    the int8 MRF convs alone, the stage without prologue and epilogue, with
    their TOP/s) and bf16 K2 on the same inputs and float32 weights, stage
    and MRF convs alone, as the yardstick."""
    import numpy as np
    import torch

    from viettts_tpu_torch.ops.mrf import (
        convt_f64, fused_mrf, fused_mrf_plain, mrf_walk, prepare_mrf_weights,
    )

    rng = np.random.default_rng(2)
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    bf16 = torch.bfloat16
    worst = {"max_abs_err": 0.0, "rel_rms": 0.0, "code_flips": 0, "codes": 0}
    times = {}  # times[(B, T)] = per stage {name: ms or TOP/s}
    for resblock2 in (False, True):
        for B, T in cases:
            timed = not resblock2 and (B, T) in timed_cases
            for i, (C_in, C, k_u, u, L_in, post) in enumerate(stage_shapes(cfg, T)):
                w32, ups32, pst32 = stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, resblock2, torch.float32)
                x = torch.from_numpy(seeded(rng, B, L_in, C_in)).to(dev, bf16)
                _, amax = mrf_walk(x.float().transpose(1, 2), w32, ks, ds, lambda j, y: y.abs().amax(), upsample=ups32)
                w, ups, pst = prepare_mrf_weights(w32, ups32, pst32, bf16, quantize_int8=True)
                h = torch.from_numpy(seeded(rng, B, L_in * u, C)).to(dev, bf16)  # the MRF convs' input
                row = {}
                for mode, act in (("static", torch.stack(amax)), ("dynamic", None)):
                    kw = dict(upsample=ups, post=pst, compute_dtype=bf16, quantize_int8=True, act_scales=act)
                    got = fused_mrf(x, w, ks, ds, **kw)
                    want = fused_mrf_plain(x, w, ks, ds, **kw)
                    if got.shape != want.shape or got.dtype != want.dtype:
                        raise AssertionError(f"K3 stage {i}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
                    got, want = got.float(), want.float()
                    err, rel = (got - want).abs().max().item(), rel_rms(got, want)
                    flips = first_code_flips(x, ups, None if act is None else act[0])
                    worst["max_abs_err"] = max(worst["max_abs_err"], err)
                    worst["rel_rms"] = max(worst["rel_rms"], rel)
                    worst["code_flips"] += flips
                    worst["codes"] += B * L_in * u * C
                    bar = K3_MAX_REL * max(want.abs().max().item(), 1.0)
                    tag = (f"K3 fused_mrf int8 {mode} resblock{'2' if resblock2 else '1'} stage {i} "
                           f"x=[{B},{L_in},{C_in}] -> [{B},{L_in * u},{1 if post else C}]")
                    log(f"{tag}: max|kernel - twin| = {err:.3e} (atol {bar:.3g}), rel-RMS {rel:.2e} "
                        f"(bar {K3_REL_RMS}), first-conv codes flipped {flips} of {B * L_in * u * C}")
                    if not (torch.isfinite(got).all() and err <= bar and rel <= K3_REL_RMS):
                        raise AssertionError(f"{tag} differs from its twin: max {err}, rel-RMS {rel}")
                    if timed:
                        sfx = "" if mode == "static" else "_dynamic"
                        row["ms" + sfx] = time_ms(lambda: fused_mrf(x, w, ks, ds, **kw))
                        row["plain_ms" + sfx] = time_ms(lambda: fused_mrf_plain(x, w, ks, ds, **kw))
                        row["mrf_ms" + sfx] = time_ms(
                            lambda: fused_mrf(h, w, ks, ds, compute_dtype=bf16, quantize_int8=True, act_scales=act))
                if timed:
                    xf = x.float()
                    row["prologue_ms"] = time_ms(lambda: convt_f64(xf, ups[0], ups[1], u))
                    row["mrf_tops"] = mrf_flop(cfg, B, L_in * u, C, False) / row["mrf_ms"] / 1e9
                    wb, ub, pb = prepare_mrf_weights(w32, ups32, pst32, bf16)
                    row["bf16_ms"] = time_ms(lambda: fused_mrf(x, wb, ks, ds, upsample=ub, post=pb, compute_dtype=bf16))
                    row["bf16_mrf_ms"] = time_ms(lambda: fused_mrf(h, wb, ks, ds, compute_dtype=bf16))
                    times.setdefault((B, T), []).append(row)
                    log(f"K3 fused_mrf int8 stage {i} B={B} {T} frames: kernel {row['ms']:.3f} ms static, "
                        f"{row['ms_dynamic']:.3f} dynamic (twin {row['plain_ms']:.3f} / {row['plain_ms_dynamic']:.3f}); "
                        f"prologue alone {row['prologue_ms']:.3f} ms; MRF convs alone {row['mrf_ms']:.3f} ms = "
                        f"{row['mrf_tops']:.1f} TOP/s ({100 * row['mrf_tops'] / (PEAK_INT8_OPS / 1e12):.1f}% of "
                        f"the {PEAK_INT8_OPS / 1e12:.0f} TOP/s dense int8 peak), dynamic {row['mrf_ms_dynamic']:.3f} ms; "
                        f"bf16 K2 on the same inputs {row['bf16_ms']:.3f} ms (MRF convs {row['bf16_mrf_ms']:.3f} ms)")
    for (B, T), rows in times.items():
        total = {key: sum(r[key] for r in rows) for key in rows[0] if key != "mrf_tops"}
        log(f"K3 fused_mrf int8 B={B} {T} frames, 4 stages: kernel {total['ms']:.3f} ms static, "
            f"{total['ms_dynamic']:.3f} dynamic; twin {total['plain_ms']:.3f} / {total['plain_ms_dynamic']:.3f}; "
            f"prologues {total['prologue_ms']:.3f} ms, MRF convs {total['mrf_ms']:.3f} ms; "
            f"bf16 K2 {total['bf16_ms']:.3f} ms")
    return worst, times


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def _lstm(rng, d_in, h):
    from viettts_tpu_torch.checkpoint import LSTMParams

    s = (d_in + h) ** -0.5
    return LSTMParams(seeded(rng, d_in, 4 * h, scale=s), seeded(rng, h, 4 * h, scale=s), seeded(rng, 4 * h, scale=0.05))


def _dense(rng, i, o, bias=True):
    d = {"kernel": seeded(rng, i, o, scale=i ** -0.5)}
    if bias:
        d["bias"] = seeded(rng, o, scale=0.05)
    return d


def _conv(rng, k, i, o, gain=1.0):
    return {"kernel": seeded(rng, k, i, o, scale=gain * (k * i) ** -0.5), "bias": seeded(rng, o, scale=0.05)}


def _bn(rng, c):
    import numpy as np

    params = {"scale": 1.0 + seeded(rng, c, scale=0.1), "bias": seeded(rng, c, scale=0.05)}
    stats = {"mean": seeded(rng, c, scale=0.05), "var": np.abs(1.0 + seeded(rng, c, scale=0.1))}
    return params, stats


def _encoder(rng, vocab, C):
    p = {"embed": {"embedding": seeded(rng, vocab, C)}}
    s = {}
    for i in range(3):
        p[f"conv_{i}"] = _conv(rng, 3, C, C)
        p[f"bn_{i}"], s[f"bn_{i}"] = _bn(rng, C)
    p["lstm_fwd"], p["lstm_bwd"] = _lstm(rng, C, C), _lstm(rng, C, C)
    return p, s


def seeded_variables(cfg, seed=0):
    """Seeded numpy variable trees in the JAX package's layout for the
    three models of ``cfg``: weights at 1/sqrt(fan_in), BatchNorm near
    identity, and a duration-head bias of -2.5 so that tokens last about
    80 ms, a speaking pace."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dc, ac, hc = cfg.duration, cfg.acoustic, cfg.hifigan

    enc_p, enc_s = _encoder(rng, dc.vocab_size, dc.lstm_dim)
    head = _dense(rng, dc.lstm_dim, 1)
    head["bias"] = np.full((1,), -2.5, np.float32)
    duration = {
        "params": {"encoder": enc_p, "proj_0": _dense(rng, 2 * dc.lstm_dim, dc.lstm_dim), "proj_1": head},
        "batch_stats": {"encoder": enc_s},
    }

    C, P, H, D = 2 * ac.encoder_dim, ac.prenet_dim, ac.decoder_dim, ac.mel_dim
    enc_p, enc_s = _encoder(rng, ac.vocab_size, ac.encoder_dim)
    params = {
        "encoder": enc_p,
        "decoder_lstm1": _lstm(rng, C + P, H),
        "decoder_lstm2": _lstm(rng, C + P + H, H),
        "prenet_fc1": _dense(rng, D, P, bias=False),
        "prenet_fc2": _dense(rng, P, P, bias=False),
        "projection": _dense(rng, 2 * H, D),
    }
    stats = {"encoder": enc_s}
    dims = [D] + [ac.postnet_dim] * 4 + [D]
    for i in range(5):
        params[f"postnet_conv_{i}"] = _conv(rng, 5, dims[i], dims[i + 1])
    for i in range(4):
        params[f"postnet_bn_{i}"], stats[f"postnet_bn_{i}"] = _bn(rng, ac.postnet_dim)
    acoustic = {"params": params, "batch_stats": stats}

    c0 = hc.upsample_initial_channel
    gen = {"conv_pre": _conv(rng, 7, hc.mel_dim, c0)}
    n = len(hc.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(hc.upsample_rates, hc.upsample_kernel_sizes)):
        ch = c0 // 2 ** (i + 1)
        gen[f"ups_{i}"] = {
            "kernel": seeded(rng, k, 2 * ch, ch, scale=(k * 2 * ch / u) ** -0.5),
            "bias": seeded(rng, ch, scale=0.05),
        }
        for j, (rk, rd) in enumerate(zip(hc.resblock_kernel_sizes, hc.resblock_dilation_sizes)):
            names = [f"convs1_{m}" for m in range(len(rd))] + [f"convs2_{m}" for m in range(len(rd))]
            gen[f"resblock_{i * n + j}"] = {nm: _conv(rng, rk, ch, ch, gain=0.5) for nm in names}
    gen["conv_post"] = _conv(rng, 7, c0 // 2 ** len(hc.upsample_rates), 1, gain=2.0)
    return {"duration": duration, "acoustic": acoustic, "hifigan": {"params": gen}}


def write_checkpoints(cfg, d: Path) -> None:
    import pickle

    from viettts_tpu_torch.checkpoint import NATIVE_FORMAT

    for kind, variables in seeded_variables(cfg).items():
        with open(d / f"{kind}_latest_ckpt.pickle", "wb") as f:
            pickle.dump({"format": NATIVE_FORMAT, "step": 0, "variables": variables}, f)


def check_result(res, what):
    import numpy as np

    wave = res.wave
    if not np.all(np.isfinite(wave)) or not np.all(np.isfinite(res.mel)):
        raise AssertionError(f"{what}: non-finite output")
    if np.abs(wave).max() > 1.0:
        raise AssertionError(f"{what}: |wave| > 1")
    if len(wave) != res.mel.shape[0] * 256 or res.mel.shape[1] != 80 or len(wave) == 0:
        raise AssertionError(f"{what}: wave {wave.shape} does not fit mel {res.mel.shape}")


def main_path(cfg, ckpt_dir: Path, out_dir: Path, device="cuda"):
    """CLI + synthesize_batch on both vocoder routes; returns timings.  The
    CLI builds its own ``Config()``, which must be ``cfg``'s shape."""
    import numpy as np

    from viettts_tpu_torch import synthesizer as cli
    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    sr = cfg.dsp.sample_rate
    stats = {}
    for route, flags in (("bf16", []), ("f32", ["--quality"])):
        wav = out_dir / f"cli_{route}.wav"
        t0 = time.perf_counter()
        rc = cli.main(["--text", SENTENCE, "--output", str(wav), "--ckpt-dir", str(ckpt_dir),
                       "--device", device, *flags])
        if rc != 0:
            raise AssertionError(f"CLI ({route}) returned {rc}")
        with wave.open(str(wav), "rb") as w:
            n = w.getnframes()
        if n == 0 or n % 256:
            raise AssertionError(f"CLI ({route}) wrote {n} samples")
        log(f"main path: CLI {route} wrote {n / sr:.2f} s of audio "
            f"in {time.perf_counter() - t0:.2f} s (model load and first calls included)")

        rcfg = cfg.replace(ckpt_dir=ckpt_dir)
        if route == "f32":
            rcfg = apply_overrides(rcfg, ["hifigan.inference_dtype=float32"])
        synth = Synthesizer(rcfg, device=device)
        check_result(synth.synthesize(SENTENCE), f"synthesize ({route})")
        lat = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = synth.synthesize(SENTENCE)
            lat.append(time.perf_counter() - t0)
        check_result(res, f"synthesize ({route})")
        results = synth.synthesize_batch(BATCH_TEXTS)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            results = synth.synthesize_batch(BATCH_TEXTS)
            walls.append(time.perf_counter() - t0)
        for i, r in enumerate(results):
            check_result(r, f"synthesize_batch[{i}] ({route})")
        audio_s = sum(len(r.wave) for r in results) / sr
        b1 = float(np.median(lat))
        b4 = audio_s / float(np.median(walls))
        stats[route] = {"b1_latency_s": b1, "b1_audio_s": len(res.wave) / sr,
                        "b4_s_audio_per_s": b4, "b4_audio_s": audio_s}
        log(f"main path {route}: B=1 latency {b1 * 1e3:.1f} ms for {len(res.wave) / sr:.2f} s of audio; "
            f"batch-4 throughput {b4:.1f} s-audio/s ({audio_s:.2f} s of audio)")
    return stats


def _http(base, path, text=None):
    import urllib.request

    data = None if text is None else json.dumps({"text": text}).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def int8_path(cfg, ckpt_dir: Path, out_dir: Path, device="cuda"):
    """The int8 route through the CLI (``--stream``), the Synthesizer
    (``warmup``, ``synthesize``, ``synthesize_batch``, ``stream``) and the
    server; returns timings and the server's /stats."""
    import threading

    import numpy as np

    from viettts_tpu_torch import serve
    from viettts_tpu_torch import synthesizer as cli
    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    sr = cfg.dsp.sample_rate
    int8 = ["--set", "hifigan.inference_dtype=int8"]
    wav = out_dir / "cli_int8_stream.wav"
    t0 = time.perf_counter()
    rc = cli.main(["--text", STREAM_TEXT, "--output", str(wav), "--ckpt-dir", str(ckpt_dir),
                   "--device", device, "--stream", *int8])
    if rc != 0:
        raise AssertionError(f"CLI (int8, --stream) returned {rc}")
    with wave.open(str(wav), "rb") as w:
        n = w.getnframes()
    if n == 0 or n % 256:
        raise AssertionError(f"CLI (int8, --stream) wrote {n} samples")
    log(f"int8 path: CLI --stream wrote {n / sr:.2f} s of audio in {time.perf_counter() - t0:.2f} s "
        f"(model load and first calls included; dynamic scales)")

    synth = Synthesizer(apply_overrides(cfg.replace(ckpt_dir=ckpt_dir), int8[1:]), device=device)
    t0 = time.perf_counter()
    synth.warmup()
    warmup_s = time.perf_counter() - t0
    if synth._act_scales is None:
        raise AssertionError("warmup() left the int8 route uncalibrated")
    log(f"int8 path: warmup (calibration + {len(synth.token_buckets)} token buckets) {warmup_s:.2f} s; "
        f"per-stage max act scale {[round(float(v.max()), 3) for v in synth._act_scales.values()]}")
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = synth.synthesize(SENTENCE)
        lat.append(time.perf_counter() - t0)
    check_result(res, "synthesize (int8)")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        results = synth.synthesize_batch(BATCH_TEXTS)
        walls.append(time.perf_counter() - t0)
    for i, r in enumerate(results):
        check_result(r, f"synthesize_batch[{i}] (int8)")
    audio_s = sum(len(r.wave) for r in results) / sr
    firsts, totals = [], []
    for _ in range(3):  # time to first audio: the median of 3 streams
        t0 = time.perf_counter()
        first_s, chunks = None, []
        for chunk in synth.stream(STREAM_TEXT):
            first_s = first_s or time.perf_counter() - t0
            check_result(chunk, f"stream chunk {len(chunks)} (int8)")
            chunks.append(chunk)
        totals.append(time.perf_counter() - t0)
        firsts.append(first_s)
        if len(chunks) < 2:
            raise AssertionError(f"stream gave {len(chunks)} chunk(s) for a multi-sentence text")
    first_s, stream_s = float(np.median(firsts)), float(np.median(totals))
    stats = {"b1_latency_s": float(np.median(lat)), "b1_audio_s": len(res.wave) / sr,
             "b4_s_audio_per_s": audio_s / float(np.median(walls)), "b4_audio_s": audio_s,
             "warmup_s": warmup_s, "stream_chunks": len(chunks), "stream_first_chunk_s": first_s,
             "stream_first_chunk_samples_s": firsts, "stream_total_s": stream_s,
             "stream_audio_s": sum(len(c.wave) for c in chunks) / sr}
    log(f"main path int8: B=1 latency {stats['b1_latency_s'] * 1e3:.1f} ms for {stats['b1_audio_s']:.2f} s of audio; "
        f"batch-4 throughput {stats['b4_s_audio_per_s']:.1f} s-audio/s; stream {len(chunks)} chunks, "
        f"first after {first_s * 1e3:.1f} ms (median of 3: {[round(1e3 * f, 1) for f in firsts]}), "
        f"all {stats['stream_audio_s']:.2f} s of audio in {stream_s * 1e3:.1f} ms")

    server = serve.build_server(["--host", "127.0.0.1", "--port", "0", "--ckpt-dir", str(ckpt_dir),
                                 "--device", device, "--warmup", "--int8-probe-every", "1", *int8])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        blobs = [_http(base, "/tts", text) for text in (SENTENCE, BATCH_TEXTS[2])]
        pcm = _http(base, "/tts/stream", STREAM_TEXT)
        deadline = time.monotonic() + 60
        while True:  # the worker counts a batch just after answering it
            served = json.loads(_http(base, "/stats"))
            if served["batches"] >= 2 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")
    if any(len(b) <= 44 for b in blobs) or len(pcm) == 0 or len(pcm) % 2:
        raise AssertionError(f"server answered {[len(b) for b in blobs]} wav bytes and {len(pcm)} PCM bytes")
    if "int8_max_clip_fraction" not in served or served["batches"] < 2:
        raise AssertionError(f"/stats after two int8 batches: {served}")
    log(f"int8 path: server answered /tts twice ({[len(b) for b in blobs]} bytes), /tts/stream "
        f"({len(pcm) // 2 / sr:.2f} s of audio); /stats {served}")
    stats["server_stats"] = served
    return stats, synth


def reference_check_int8(cfg, ckpt_dir: Path, gpu_synth):
    """The int8 route with the card's calibrated scales on both sides: the
    card's vocoder (K2, K3) against the CPU's (plain twins) on the same
    decoded mel, and against the card's float32 route within the int8
    quantization bar of tests/test_mrf.py (0.05 rel-RMS).  End to end,
    prenet dropout off, the two mels differ by ~1e-6 (K1 against its twin);
    a one-ulp change of a bf16 mel value flips int8 codes that the
    residual chains carry on, so that difference is logged, not held to
    the vocoder's bar."""
    import numpy as np
    import torch

    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    cfg = apply_overrides(
        cfg.replace(ckpt_dir=ckpt_dir),
        ["hifigan.inference_dtype=int8", "acoustic.prenet_dropout_at_inference=false"],
    )
    gpu, cpu = Synthesizer(cfg, device="cuda"), Synthesizer(cfg, device="cpu")
    f32 = Synthesizer(apply_overrides(cfg, ["hifigan.inference_dtype=float32"]), device="cuda")
    gpu._act_scales = gpu_synth._act_scales
    cpu._act_scales = {i: s.cpu() for i, s in gpu_synth._act_scales.items()}
    text = BATCH_TEXTS[0]
    mel = gpu._calibration_mel(text).cpu().numpy()
    got, want = torch.from_numpy(gpu.vocode(mel)), torch.from_numpy(cpu.vocode(mel))
    g, c = gpu.synthesize(text), cpu.synthesize(text)
    errs = {"vocoder_wave": float((got - want).abs().max()), "vocoder_wave_rel_rms": rel_rms(got, want),
            "int8_vs_f32_rel_rms": rel_rms(got, torch.from_numpy(f32.vocode(mel))),
            "mel": float(np.abs(g.mel - c.mel).max()) if g.mel.shape == c.mel.shape else float("inf"),
            "end_to_end_wave_rel_rms": rel_rms(torch.from_numpy(g.wave), torch.from_numpy(c.wave))
            if g.wave.shape == c.wave.shape else float("inf")}
    log(f"reference int8: card vs CPU, vocoder on the same {mel.shape[1]}-frame mel and end to end on "
        f"{g.mel.shape[0]} frames: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if not (errs["vocoder_wave_rel_rms"] <= INT8_ROUTE_REL_RMS
            and errs["vocoder_wave"] <= K3_MAX_REL * max(float(want.abs().max()), 1.0)
            and errs["int8_vs_f32_rel_rms"] <= INT8_VS_F32_REL_RMS and errs["mel"] <= 1e-3):
        raise AssertionError(f"int8 route differs: {errs}")
    return errs


def reference_check(cfg, ckpt_dir: Path, device="cuda"):
    """float32, prenet dropout off: the card (kernels) against the CPU
    (plain twins) on one short text."""
    import numpy as np

    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    cfg = apply_overrides(
        cfg.replace(ckpt_dir=ckpt_dir),
        ["hifigan.inference_dtype=float32", "acoustic.prenet_dropout_at_inference=false"],
    )
    text = BATCH_TEXTS[0]
    gpu = Synthesizer(cfg, device=device).synthesize(text)
    cpu = Synthesizer(cfg, device="cpu").synthesize(text)
    errs = {
        "durations": float(np.abs(gpu.durations - cpu.durations).max()),
        "mel": float(np.abs(gpu.mel - cpu.mel).max()) if gpu.mel.shape == cpu.mel.shape else float("inf"),
        "wave": float(np.abs(gpu.wave - cpu.wave).max()) if gpu.wave.shape == cpu.wave.shape else float("inf"),
    }
    log(f"reference: card vs CPU on {gpu.mel.shape[0]} frames: "
        + ", ".join(f"max|d {k}| = {v:.3e}" for k, v in errs.items()))
    bars = {"durations": 1e-4, "mel": 1e-3, "wave": 1e-3}
    for k, bar in bars.items():
        if not errs[k] <= bar:
            raise AssertionError(f"card and CPU differ in {k} by {errs[k]} (bar {bar})")
    return errs


# ---------------------------------------------------------------------------
# Phase 4: the training slice
# ---------------------------------------------------------------------------

# A synthetic aligned corpus (this script's own copy of the renderer of
# scripts/validate_e2e_training.py, which imports jax): each vowel a
# harmonic tone at its own pitch, consonants noise or hum, per-phoneme
# mean durations, MFA-style TextGrids with words and phones tiers.
CORPUS_SR = 16000
VOWELS = {"a": 240.0, "e": 360.0, "i": 480.0, "o": 600.0, "u": 720.0}
CONSONANTS = ("b", "m", "t", "s")
DUR_MEAN = {**{v: 0.18 for v in VOWELS}, "b": 0.08, "m": 0.10, "t": 0.06, "s": 0.09}
WORDS = [c + v for c in CONSONANTS for v in VOWELS] + ["bami", "tasu", "mibo", "sute", "bota", "misa"]
CORPUS_UTTERANCES = 96  # 91 train / 5 val at train_split 0.95: one batch of 64
DURATION_STEPS, ACOUSTIC_STEPS = 20, 6
TRAIN_REL = 1e-4  # card against CPU, one step, of each leaf's largest value


def render_phoneme(ph, dur_s, rng):
    import numpy as np

    n = int(round(dur_s * CORPUS_SR))
    t = np.arange(n) / CORPUS_SR
    if ph in VOWELS:
        f0 = VOWELS[ph]
        sig = sum((0.5 / h) * np.sin(2 * np.pi * f0 * h * t) for h in (1, 2, 3))
        env = np.minimum(1.0, np.minimum(t, t[::-1] + 1e-9) / 0.02)
        return sig * env
    if ph == "s":
        return 0.25 * np.convolve(rng.randn(n), [1, -0.95], mode="same")
    if ph == "t":
        return 0.5 * rng.randn(n) * np.exp(-t / 0.015)
    return 0.4 * np.sin(2 * np.pi * 120.0 * t) * np.exp(-t / 0.08)


def render_sentence(words, rng, jitter=0.15):
    import numpy as np

    intervals = [("sil", 0.15 + 0.1 * rng.rand())]
    for k, w in enumerate(words):
        for ph in w:
            intervals.append((ph, DUR_MEAN[ph] * (1.0 + jitter * (2 * rng.rand() - 1))))
        if k < len(words) - 1 and rng.rand() < 0.3:
            intervals.append(("sil", 0.1 + 0.1 * rng.rand()))
    intervals.append(("sil", 0.15 + 0.1 * rng.rand()))
    parts = [np.zeros(int(round(d * CORPUS_SR))) if ph == "sil" else render_phoneme(ph, d, rng)
             for ph, d in intervals]
    wav = np.concatenate(parts)
    return 0.7 * wav / max(np.abs(wav).max(), 1e-6), intervals


def textgrid_for(words, intervals):
    def fmt(items):
        rows, t = [], 0.0
        for i, (text, d) in enumerate(items):
            rows.append(f"        intervals [{i + 1}]:\n            xmin = {t:.6f}\n"
                        f"            xmax = {t + d:.6f}\n            text = \"{text}\"\n")
            t += d
        return "".join(rows), t

    word_items, i, wi = [], 0, 0
    while i < len(intervals):
        if intervals[i][0] == "sil":
            word_items.append(("", intervals[i][1]))
            i += 1
            continue
        span = 0.0
        for _ in words[wi]:
            span += intervals[i][1]
            i += 1
        word_items.append((words[wi], span))
        wi += 1
    ptxt, total = fmt(intervals)
    wtxt, _ = fmt(word_items)
    tier = '        class = "IntervalTier"\n        name = "{}"\n        xmin = 0\n        xmax = {:.6f}\n'
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
            f"xmin = 0\nxmax = {total:.6f}\ntiers? <exists>\nsize = 2\nitem []:\n"
            "    item [1]:\n" + tier.format("words", total) + f"        intervals: size = {len(word_items)}\n{wtxt}"
            "    item [2]:\n" + tier.format("phones", total) + f"        intervals: size = {len(intervals)}\n{ptxt}")


def build_corpus(d: Path, n_utts=CORPUS_UTTERANCES, seed=0):
    import numpy as np

    from viettts_tpu_torch.audio import write_wav

    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n_utts):
        words = [WORDS[rng.randint(len(WORDS))] for _ in range(rng.randint(3, 7))]
        wav, intervals = render_sentence(words, rng)
        write_wav(d / f"utt{i:03d}.wav", wav.astype(np.float32), CORPUS_SR)
        (d / f"utt{i:03d}.TextGrid").write_text(textgrid_for(words, intervals))


def duration_step_flop(cfg):
    """Multiply-adds x 2 of one duration step from the shapes: encoder
    convs, both LSTM directions (input and recurrent projections), the two
    dense heads; backward counted as twice the forward."""
    B, T, C = cfg.train.batch_size, cfg.data.max_phoneme_seq_len, cfg.duration.lstm_dim
    fwd = 3 * 2 * B * T * 3 * C * C + 2 * 2 * (2 * B * T * C * 4 * C) + 2 * B * T * (2 * C * C + C)
    return 3.0 * fwd


def acoustic_step_flop(cfg):
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


def run_trainer(name, module, cfg):
    """One trainer at ``cfg``: per-step seconds and losses (each step waits
    for the device), peak device memory, FLOPs and their bound."""
    import numpy as np
    import torch

    steps = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    module.train(cfg, device="cuda", step_log=steps)
    wall = time.perf_counter() - t0
    ms = [1e3 * s for s, _ in steps]
    losses = [loss for _, loss in steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name} trainer: non-finite loss {losses}")
    flop = duration_step_flop(cfg) if name == "duration" else acoustic_step_flop(cfg)
    bound_ms = 1e3 * flop / PEAK_F32_FLOPS
    stats = {"steps": len(steps), "first_step_ms": ms[0], "median_ms": float(np.median(ms[1:])),
             "ms": ms, "first_loss": losses[0], "last_loss": losses[-1],
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "flop_per_step": flop,
             "bound_ms": bound_ms, "bound_by": "operations (float32 peak)", "wall_s": wall}
    log(f"train {name}: {len(steps)} steps, first {ms[0]:.1f} ms, then median {stats['median_ms']:.1f} ms/step; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak memory {stats['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
        f"{flop / 1e12:.3f} TFLOP/step, bound {bound_ms:.1f} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s "
        f"({100 * bound_ms / stats['median_ms']:.1f}% of it); {wall:.1f} s in all")
    return stats


def train_phase(cfg, tmp: Path):
    """Both trainers at the default width on a synthetic corpus, with
    PyTorch's TF32 defaults (cuDNN convs TF32, matmuls float32): the
    duration trainer 20 steps with validation and a checkpoint every 10,
    the acoustic trainer 6 steps (B=64, 768 frames) with validation every
    3.  Returns their stats and the checkpoint directory."""
    import dataclasses

    import torch

    from viettts_tpu_torch.train import acoustic, duration

    corpus, out = tmp / "corpus", tmp / "trained"
    t0 = time.perf_counter()
    build_corpus(corpus)
    log(f"train: synthetic corpus of {CORPUS_UTTERANCES} utterances in {time.perf_counter() - t0:.1f} s")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        base = cfg.replace(data_dir=corpus, ckpt_dir=out)
        stats = {
            "duration": run_trainer("duration", duration, base.replace(train=dataclasses.replace(
                cfg.train, num_training_steps=DURATION_STEPS, val_interval=10, ckpt_interval=10))),
            "acoustic": run_trainer("acoustic", acoustic, base.replace(train=dataclasses.replace(
                cfg.train, num_training_steps=ACOUSTIC_STEPS, val_interval=3))),
        }
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    for kind in ("duration", "acoustic"):
        if not (out / f"{kind}_latest_ckpt.pickle").exists():
            raise AssertionError(f"the {kind} trainer wrote no checkpoint")
    return stats, out


def gan_step_flop(cfg):
    """FLOPs (2 x multiply-adds) of one GAN step from the shapes: the
    generator (conv_pre, each stage's ConvTranspose and MRF convs,
    conv_post), the MPD and MSD convs and the log-mel DFT and filterbank,
    per waveform.  The generator runs forward and backward (3x its
    forward); the discriminators forward and backward on both waveforms in
    the discriminator step (3x each), then forward on the real one (1x)
    and forward and backward to their input, weights frozen, on the
    generated one (2x); the mel of the real audio once, of the generated
    one forward and backward to the input (2x)."""
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


GAN_STEPS, GAN_CKPT_INTERVAL, GTA_STEPS = 6, 3, 2


def run_gan(name, cfg, steps, **kw):
    """``train.hifigan.train`` to ``steps`` on the card: per-step ms and
    losses (each step waits for the device), peak memory, FLOPs and their
    bound at the float32 and TF32 peaks."""
    import numpy as np
    import torch

    from viettts_tpu_torch.train import hifigan

    log_ = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hifigan.train(cfg, num_steps=steps, device="cuda", step_log=log_, log_every=GAN_CKPT_INTERVAL, **kw)
    wall = time.perf_counter() - t0
    ms = [1e3 * s for s, _ in log_]
    losses = {k: [m[k] for _, m in log_] for k in ("disc_loss", "gen_loss", "mel_l1", "adv", "fm")}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"GAN {name}: non-finite loss {losses}")
    flop = gan_step_flop(cfg)
    median = float(np.median(ms[1:])) if len(ms) > 1 else ms[0]
    stats = {"steps": len(ms), "first_step_ms": ms[0], "median_ms": median, "ms": ms,
             "first": {k: v[0] for k, v in losses.items()}, "last": {k: v[-1] for k, v in losses.items()},
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "flop_per_step": flop,
             "bound_ms_f32": 1e3 * flop / PEAK_F32_FLOPS, "bound_ms_tf32": 1e3 * flop / (PEAK_TFLOPS["float32"] * 1e12),
             "wall_s": wall}
    log(f"GAN {name}: {len(ms)} steps, first {ms[0]:.1f} ms, then median {median:.1f} ms/step; "
        + "; ".join(f"{k} {losses[k][0]:.4f} -> {losses[k][-1]:.4f}" for k in ("disc_loss", "gen_loss", "mel_l1"))
        + f"; peak memory {stats['max_memory_allocated_bytes'] / 2**30:.2f} GiB; {flop / 1e12:.3f} TFLOP/step, "
        f"bound {stats['bound_ms_f32']:.1f} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32, "
        f"{stats['bound_ms_tf32']:.1f} ms at {PEAK_TFLOPS['float32']:.0f} TF32; {wall:.1f} s in all")
    return stats


def gan_phase(cfg, corpus: Path, trained: Path, tmp: Path):
    """The vocoder half of the recipe on the card, TF32 on in cuDNN as in
    the train phase: silence zeroing, 6 GAN steps (audio only) with a
    checkpoint every 3, the GTA export from the trained acoustic model, and
    2 GTA steps resuming that checkpoint in a second directory.  Returns
    the stats and the GAN-trained vocoder checkpoint."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from viettts_tpu_torch.checkpoint import load_pickle
    from viettts_tpu_torch.tools import gta, zero_silence_segments

    wavs, gta_dir, audio_dir, ft_dir = tmp / "wavs_zeroed", tmp / "gta", tmp / "gan", tmp / "gan_gta"
    zero_silence_segments.main(["-i", str(corpus), "-o", str(wavs)])
    base = cfg.replace(train=dataclasses.replace(cfg.train, ckpt_interval=GAN_CKPT_INTERVAL))
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        stats = {"audio": run_gan("audio-only", base.replace(ckpt_dir=audio_dir), GAN_STEPS, wav_dir=wavs)}
        t0 = time.perf_counter()
        n = gta.generate_gta(gta_dir, cfg.replace(data_dir=corpus, ckpt_dir=trained), device="cuda")
        mels = [np.load(f) for f in sorted(gta_dir.glob("*.npy"))]
        if n != CORPUS_UTTERANCES or len(mels) != n or not all(np.isfinite(m).all() and m.shape[0] == 80 for m in mels):
            raise AssertionError(f"GTA export wrote {n} files, {len(mels)} readable and finite")
        stats["gta_export"] = {"files": n, "s": time.perf_counter() - t0, "frames": sum(m.shape[1] for m in mels)}
        log(f"GTA export: {n} mels, {stats['gta_export']['frames']} frames, in {stats['gta_export']['s']:.1f} s")
        ft_dir.mkdir()
        shutil.copy(audio_dir / "hifigan_latest_ckpt.pickle", ft_dir / "hifigan_latest_ckpt.pickle")
        stats["gta"] = run_gan("GTA finetune", base.replace(ckpt_dir=ft_dir), GAN_STEPS + GTA_STEPS,
                               wav_dir=wavs, gta_dir=gta_dir)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    ckpt = ft_dir / "hifigan_latest_ckpt.pickle"
    step = load_pickle(ckpt)["step"]
    if stats["gta"]["steps"] != GTA_STEPS or step != GAN_STEPS + GTA_STEPS:
        raise AssertionError(f"GTA finetune took {stats['gta']['steps']} steps to step {step}")
    return stats, ckpt


def round_trip(cfg, trained: Path, vocoder: Path, gan_steps: int):
    """The trainers' checkpoints, read by the port's ``load_variables``,
    into Synthesizers with the GAN-trained vocoder: ``SENTENCE`` on the
    card on the float32, bf16 and int8 routes (K1, K2, K3 on trained
    weights; int8 calibrated by ``warmup()``), and the bf16 and int8
    vocoders against float32 on the float32 route's mel."""
    import shutil

    import torch

    from viettts_tpu_torch.checkpoint import load_variables
    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    shutil.copy(vocoder, trained / "hifigan_latest_ckpt.pickle")
    for kind in ("duration", "acoustic"):
        variables = load_variables(trained / f"{kind}_latest_ckpt.pickle", kind)
        if sorted(variables) != ["batch_stats", "params"]:
            raise AssertionError(f"{kind} checkpoint holds {sorted(variables)}")
    if sorted(load_variables(trained / "hifigan_latest_ckpt.pickle", "hifigan")) != ["params"]:
        raise AssertionError("the GAN checkpoint holds no folded inference params")
    out, waves, mel = {}, {}, None
    for route in ("float32", "bfloat16", "int8"):
        synth = Synthesizer(apply_overrides(cfg.replace(ckpt_dir=trained), [f"hifigan.inference_dtype={route}"]),
                            device="cuda")
        if route == "int8":
            synth.warmup()
        res = synth.synthesize(SENTENCE)
        check_result(res, f"synthesize ({route}, trained checkpoints)")
        if mel is None:
            mel = res.mel[None]
        waves[route] = torch.from_numpy(synth.vocode(mel))
        out[route] = {"audio_s": len(res.wave) / cfg.dsp.sample_rate, "frames": res.mel.shape[0]}
    for route in ("bfloat16", "int8"):
        out[route]["vs_f32_rel_rms"] = rel_rms(waves[route], waves["float32"])
        out[route]["vs_f32_max_abs"] = float((waves[route] - waves["float32"]).abs().max())
    out["float32"]["wave_rms"] = float(waves["float32"].pow(2).mean().sqrt())
    log(f"train round trip ({gan_steps}-step GAN vocoder, not trained weights): {out['float32']['audio_s']:.2f} s "
        f"of audio on each route; on the float32 route's {mel.shape[1]}-frame mel, wave rms "
        f"{out['float32']['wave_rms']:.3e}; bf16 vs f32 rel-RMS {out['bfloat16']['vs_f32_rel_rms']:.3e}, max abs "
        f"{out['bfloat16']['vs_f32_max_abs']:.3e}; int8 vs f32 rel-RMS {out['int8']['vs_f32_rel_rms']:.3e}, "
        f"max abs {out['int8']['vs_f32_max_abs']:.3e}")
    return out


def _seed_values(model, seed):
    """Seeded values for every parameter and statistic: matrices at
    1/sqrt(fan_in), biases ~0.05, BatchNorm scales and variances near 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            noise = torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
            if "running_var" in name or ("bns." in name and name.endswith("weight")):
                t.copy_(1.0 + 0.1 * noise.abs())
            elif t.dim() >= 2:  # conv (O, I, W): fan_in I * W; matrices: the larger side
                t.copy_(noise / np.sqrt(t[0].numel() if t.dim() == 3 else max(t.shape)))
            else:
                t.copy_(0.05 * noise)


def _one_step(kind, cfg, batch, device, lr):
    import torch

    from viettts_tpu_torch.data.loader import to_device
    from viettts_tpu_torch.models.acoustic import AcousticModel
    from viettts_tpu_torch.models.duration import DurationModel
    from viettts_tpu_torch.models.layers import batch_stats
    from viettts_tpu_torch.ops.mel import LogMelSpectrogram
    from viettts_tpu_torch.train import acoustic, duration
    from viettts_tpu_torch.train.common import init_train_state, make_optimizer, make_update_fn

    model = (DurationModel(cfg.duration) if kind == "duration" else AcousticModel(cfg.acoustic))
    _seed_values(model, 0)
    model.to(device)
    before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    if kind == "duration":
        loss_fn = duration.make_loss_fn(model, 0.0, train=True)
    else:
        loss_fn = acoustic.make_loss_fn(model, LogMelSpectrogram(cfg.dsp).to(device), cfg.dsp.hop_length, train=True)
    opt = make_optimizer(lr)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), opt,
                             torch.Generator(device).manual_seed(0))
    state, loss = make_update_fn(loss_fn, opt)(state, [to_device(batch, torch.device(device))])
    return float(loss), {k: v.detach().cpu() for k, v in {**state.params, **state.batch_stats}.items()}, before


def train_card_vs_cpu():
    """One training step of each model at a small config (widths 32-64, 8
    mels, B=4, 16 tokens, 48 frames; every dropout and zoneout off), on
    the card and on the CPU, TF32 off for matmuls and cuDNN convs: loss,
    parameters and batch statistics after the step within 1e-4 of each
    leaf's largest value.  Adam's first step is ``lr * g / (|g| + 1e-8)``,
    so an element whose gradient is near zero moves by a fraction of lr
    that rounding decides; at the trainers' lr of 1e-4 that stays below
    the bar.  A conv bias that feeds a BatchNorm has a zero gradient in
    exact arithmetic, which Adam scales to a full step of either sign:
    there each side must have moved by at most the learning rate."""
    import numpy as np
    import torch

    from viettts_tpu_torch.config import AcousticModelConfig, Config, DspConfig, DurationModelConfig
    from viettts_tpu_torch.types import AcousticBatch, DurationBatch

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the card-vs-CPU step")
    cfg = Config(
        dsp=DspConfig(n_fft=256, hop_length=64, win_length=256, mel_dim=8),
        duration=DurationModelConfig(vocab_size=96, lstm_dim=32, dropout_rate=0.0),
        acoustic=AcousticModelConfig(vocab_size=96, encoder_dim=32, decoder_dim=64, prenet_dim=32,
                                     postnet_dim=32, mel_dim=8, encoder_dropout_rate=0.0,
                                     prenet_dropout_rate=0.0, postnet_dropout_rate=0.0,
                                     prenet_dropout_at_inference=False, zoneout_rate=0.0),
    )
    rng = np.random.default_rng(4)
    B, T, frames, lr = 4, 16, 48, 1e-4  # the trainers' default learning rate
    lengths = np.asarray([16, 13, 9, 5], np.int32)
    toks = rng.integers(4, 96, (B, T)).astype(np.int32)
    durs = rng.uniform(0.02, 0.06, (B, T)).astype(np.float32)
    toks[:, 2] = 3
    for i, n in enumerate(lengths):
        toks[i, n:], durs[i, n:] = 0, 0.0
    wavs = (rng.standard_normal((B, frames * 64)) * 3000).astype(np.int16)
    wav_lengths = np.asarray([frames * 64, 2800, 2000, 1200], np.int32)
    batches = {"duration": DurationBatch(toks, lengths, durs),
               "acoustic": AcousticBatch(toks, lengths, durs, wavs, wav_lengths, None)}
    errs = {}
    for kind, batch in batches.items():
        loss_card, card, before = _one_step(kind, cfg, batch, "cuda", lr)
        loss_cpu, cpu, _ = _one_step(kind, cfg, batch, "cpu", lr)
        worst = abs(loss_card - loss_cpu) / abs(loss_cpu)
        if not (np.isfinite(loss_card) and worst <= TRAIN_REL):
            raise AssertionError(f"{kind} step: loss {loss_card} on the card, {loss_cpu} on the CPU")
        for name, want in cpu.items():
            if name.endswith("bias") and "convs" in name and not name.startswith("postnet_convs.4"):
                moved = max((side - before[name]).abs().max().item() for side in (card[name], want))
                if moved > lr * 1.01:
                    raise AssertionError(f"{kind} step: zero-gradient bias {name} moved {moved}")
                continue
            rel = (card[name] - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
            worst = max(worst, rel)
            if rel > TRAIN_REL:
                raise AssertionError(f"{kind} step: {name} differs by {rel:.2e} of its largest value")
        errs[kind] = worst
        log(f"train card vs CPU, {kind}: one step, worst relative difference {worst:.2e} (bar {TRAIN_REL})")
    return errs


GAN_REL = 1e-4  # card against CPU, one GAN step: losses and spectral u


def _gan_one_step(cfg, audio, device):
    """One GAN step from the trainer's seeded cold init on ``device``:
    metrics and the new spectral state."""
    import torch

    from viettts_tpu_torch.train.hifigan import build_gan

    state, step = build_gan(cfg, device, cfg.hifigan.learning_rate)
    state, metrics = step(state, None, torch.from_numpy(audio).to(device))
    return {k: float(v) for k, v in metrics.items()}, {k: v.cpu() for k, v in state.spectral.items()}


def gan_card_vs_cpu():
    """One GAN step at a small config (generator 32 channels, one
    ResBlock1; MPD periods 2/3 at base 4; MSD 2 scales at base 16; B=4,
    segment 1024) on the card and on the CPU, TF32 off: every loss and the
    new spectral ``u`` within 1e-4 (relative; ``u`` of its largest)."""
    import numpy as np
    import torch

    from viettts_tpu_torch.config import Config, HifiGanConfig, TrainConfig

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the card-vs-CPU GAN step")
    cfg = Config(hifigan=HifiGanConfig(upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                                       resblock_dilation_sizes=((1, 3),), segment_size=1024, mpd_periods=(2, 3),
                                       mpd_base_channels=4, msd_scales=2, msd_base_channels=16),
                 train=TrainConfig(batch_size=4))
    audio = (np.random.default_rng(5).standard_normal((4, 1024)) * 0.3).astype(np.float32)
    card, u_card = _gan_one_step(cfg, audio, "cuda")
    cpu, u_cpu = _gan_one_step(cfg, audio, "cpu")
    errs = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
    errs["u"] = max(float((u_card[k] - u_cpu[k]).abs().max() / u_cpu[k].abs().max()) for k in u_cpu)
    log(f"GAN card vs CPU: one step, " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (bar {GAN_REL})")
    if not all(np.isfinite(card[k]) for k in card) or max(errs.values()) > GAN_REL:
        raise AssertionError(f"GAN step: card {card}, CPU {cpu}, relative differences {errs}")
    return errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.ops import _build
    from viettts_tpu_torch.ops.ar_decoder import ar_decode
    from viettts_tpu_torch.ops.mrf import fused_mrf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library()
    built = "found built" if _build.build_seconds is None else f"nvcc build {_build.build_seconds:.1f} s"
    log(f"kernel library {_build.library_path().name}: {built}, ready in {time.perf_counter() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = Config()

    k1_err, k1_times = check_ar_decode(dev)
    k2_err, k2_times = check_fused_mrf(dev, cfg.hifigan)
    k3, k3_times = check_fused_mrf_int8(dev, cfg.hifigan)

    def zero_counts():
        ar_decode.launches = ar_decode.plain_calls = 0
        fused_mrf.launches = fused_mrf.int8_launches = fused_mrf.plain_calls = 0

    def read_counts(path, kernels):
        counts = {"ar_decode": (ar_decode.launches, ar_decode.plain_calls),
                  "fused_mrf": (fused_mrf.launches, fused_mrf.plain_calls),
                  "fused_mrf_int8": (fused_mrf.int8_launches, fused_mrf.plain_calls)}
        log(f"{path} launches (kernel, plain twin): {counts}")
        for name in kernels:
            launches, plain = counts[name]
            if launches == 0 or plain != 0:
                raise AssertionError(f"{path}: {name} had {launches} kernel launches, {plain} plain calls")
        return {name: counts[name][0] for name in kernels}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        write_checkpoints(cfg, tmp)
        zero_counts()
        stats = main_path(cfg, tmp, tmp)
        launches = read_counts("main path (bf16, f32)", ["ar_decode", "fused_mrf"])
        zero_counts()
        stats["int8"], int8_synth = int8_path(cfg, tmp, tmp)
        launches_int8 = read_counts("main path (int8)", ["ar_decode", "fused_mrf", "fused_mrf_int8"])
        ref = reference_check(cfg, tmp)
        ref["int8"] = reference_check_int8(cfg, tmp, int8_synth)
        train, trained = train_phase(cfg, tmp)
        train["gan"], vocoder = gan_phase(cfg, tmp / "corpus", trained, tmp)
        zero_counts()
        train["round_trip"] = round_trip(cfg, trained, vocoder, GAN_STEPS + GTA_STEPS)
        launches_trained = read_counts("train round trip", ["ar_decode", "fused_mrf", "fused_mrf_int8"])
        train["card_vs_cpu"] = train_card_vs_cpu()
        train["gan_card_vs_cpu"] = gan_card_vs_cpu()

    bf16, f32 = torch.bfloat16, torch.float32

    def stage_sum(times, col, case=(2, 128)):
        return sum(r[col] for r in times[case])

    k1_main = k1_times[(1, 512)]
    k2_bound, k2_by = mrf_bound(cfg.hifigan, 2, 128, "bfloat16")
    k2_bound_f32, k2_by_f32 = mrf_bound(cfg.hifigan, 2, 128, "float32")
    k3_bound, k3_by = mrf_bound(cfg.hifigan, 2, 128, "int8")
    k3_bound_b1, _ = mrf_bound(cfg.hifigan, 1, MAIN_PATH_FRAMES, "int8")
    b1 = (1, MAIN_PATH_FRAMES)

    def k3_sum(key, case=(2, 128)):
        return sum(r[key] for r in k3_times[case])

    def mrf_flop_sum(B, T):  # the MRF convs of the four ResBlock1 stages
        return sum(mrf_flop(cfg.hifigan, B, L_in * u, C, False) for _, C, _, u, L_in, _ in stage_shapes(cfg.hifigan, T))
    kernels = [
        {"name": "ar_decode", "route": "cuda", "source": "viettts_tpu_torch/csrc/ar_decoder.cu",
         "replaces": "viettts_tpu/ops/ar_decoder.py:140", "launches": launches["ar_decode"],
         "launches_int8_path": launches_int8["ar_decode"], "launches_round_trip": launches_trained["ar_decode"],
         "max_abs_err": k1_err, "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call runs the fed-back decode",
         "cases": {f"B={B} L={L}": v for (B, L), v in k1_times.items()},
         "shape": "B=1 L=512 H=512 P=256 D=80 f32"},
        {"name": "fused_mrf", "route": "cuda", "source": "viettts_tpu_torch/csrc/mrf.cu",
         "replaces": "viettts_tpu/ops/mrf.py:440", "launches": launches["fused_mrf"],
         "launches_int8_path": launches_int8["fused_mrf"], "launches_round_trip": launches_trained["fused_mrf"],
         "max_abs_err": k2_err[f32], "max_abs_err_bf16": k2_err[bf16],
         "max_rel_rms_vs_bf16_dots_twin": k2_err["bf16_dots_rel_rms"],
         "ms": stage_sum(k2_times[bf16], 0), "plain_ms": stage_sum(k2_times[bf16], 1),
         "ms_f32": stage_sum(k2_times[f32], 0), "plain_ms_f32": stage_sum(k2_times[f32], 1),
         "bound_ms": k2_bound, "bound_by": k2_by, "bound_ms_f32": k2_bound_f32, "bound_by_f32": k2_by_f32,
         "library_ms": stage_sum(k2_times[bf16], 1),
         "library": "cuDNN conv1d per conv, i.e. the plain twin (bf16; f32 in plain_ms_f32)",
         "stages": {f"{str(dt)[6:]} B={B} T={T}": {
             "ms": [r[0] for r in rows], "plain_ms": [r[1] for r in rows],
             "mrf_ms": [r[2] for r in rows], "mrf_tflops": [r[3] for r in rows]}
             for dt in (bf16, f32) for (B, T), rows in k2_times[dt].items()},
         "shape": "4 default stages summed, B=2, 128 mel frames, ResBlock1; ms in bf16"},
        {"name": "fused_mrf_int8", "route": "cuda", "source": "viettts_tpu_torch/csrc/mrf_int8.cu",
         "replaces": "viettts_tpu/ops/mrf.py:440 (quantize_int8)", "launches": launches_int8["fused_mrf_int8"],
         "launches_round_trip": launches_trained["fused_mrf_int8"],
         "max_abs_err": k3["max_abs_err"], "rel_rms": k3["rel_rms"],
         "first_conv_code_flips": k3["code_flips"], "first_conv_codes": k3["codes"],
         "ms": k3_sum("ms"), "plain_ms": k3_sum("plain_ms"),
         "ms_dynamic": k3_sum("ms_dynamic"), "plain_ms_dynamic": k3_sum("plain_ms_dynamic"),
         "prologue_ms": k3_sum("prologue_ms"), "mrf_ms": k3_sum("mrf_ms"),
         "mrf_tops": mrf_flop_sum(2, 128) / k3_sum("mrf_ms") / 1e9,
         "bf16_ms": k3_sum("bf16_ms"), "bf16_mrf_ms": k3_sum("bf16_mrf_ms"),
         "ms_b1": k3_sum("ms", b1), "ms_dynamic_b1": k3_sum("ms_dynamic", b1),
         "plain_ms_b1": k3_sum("plain_ms", b1), "prologue_ms_b1": k3_sum("prologue_ms", b1),
         "mrf_ms_b1": k3_sum("mrf_ms", b1), "mrf_tops_b1": mrf_flop_sum(*b1) / k3_sum("mrf_ms", b1) / 1e9,
         "bf16_ms_b1": k3_sum("bf16_ms", b1), "bf16_mrf_ms_b1": k3_sum("bf16_mrf_ms", b1),
         "bound_ms": k3_bound, "bound_by": k3_by, "bound_ms_b1": k3_bound_b1, "library_ms": None,
         "library": "none: no PyTorch call runs int8 convolutions",
         "stages": {f"B={B} T={T}": {key: [r[key] for r in rows] for key in rows[0]}
                    for (B, T), rows in k3_times.items()},
         "shape": "4 default stages summed, B=2, 128 mel frames (_b1: B=1, "
                  f"{MAIN_PATH_FRAMES} frames), ResBlock1, bf16 storage; ms static scales"},
    ]
    log(json.dumps({"card": smi, "main_path": stats, "reference_errors": ref, "train": train}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
