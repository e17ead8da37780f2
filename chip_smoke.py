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
   the same inputs), K1 also under the plan of a 114-SM card (the H100
   PCIe: 103 CTAs of 5 units, forced with ``ar_decode(num_sms=114)``; B=1
   and B=4, 512 frames, against the twin and bitwise run to run, its time
   beside this card's own plan), and K1 at the decoder widths whose
   float32 gate columns do not fit the card's shared memory, where its
   plan streams some every frame (768 and Tacotron 2's 1024 at B = 1, 4,
   16 and 64, 512 frames; 2048 at B = 1 and 4, 32 frames; 1024 also under
   the 114-SM plan), with both times and each kernel's roofline bound
   (``bound_ms``: the larger of its bytes over the HBM rate and its
   operations over the dense peak of their type, ``utils.flops``: the
   card's data sheet).  Then ``check_bulk``: every stage's MRF convs at
   B=64, 768 mel frames on each route beside cuDNN conv1d and the bound,
   the stages the per-conv wgmma pipeline (``csrc/mrf_conv_wgmma.cuh``)
   takes (bf16 and static int8 at C = 256 and 128, the float32 route's
   3xTF32 and dynamic int8 at every width) beside the same stages on
   ``mma_conv_kernel``, every stage of every route held to its twin.
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
   ``synthesize_batch`` of 4 texts gives each route's MFU
   (``utils.flops.pipeline_flops`` over the wall time, against the bf16,
   TF32 or int8 peak).  The outputs must be finite, in [-1, 1] and 256
   samples per mel frame,
   and the card must agree with the CPU (plain twins): a float32 synthesis,
   and the int8 vocoder, with the card's scales, on the same mel, which
   must also stay within int8 quantization error of the float32 vocoder.
   ``synthesize`` and ``stream``'s chunk 0 take the lead program (one
   CUDA graph replay), so phase 3's B=1 numbers are its.
   c. The single-dispatch lead program (``lead_phase``) on the bf16,
   float32 and int8 routes: ``warmup()`` captures one graph per token
   bucket of at most 64 tokens (seconds per bucket, the pool's bytes); a
   replay against the eager program (float32 within 1e-5 of scale, bf16
   and int8 at K2's and K3's card bars) and two replays bitwise equal;
   3 replays counted exactly (one K1 and four vocoder-stage launches each,
   no twin); B=1 latency of ``synthesize(SENTENCE)`` and time to first
   audio of ``stream(STREAM_TEXT)`` with the lead program and with
   ``single_dispatch_max_tokens = 0``, in turns, medians of 3; then on the
   float32 route with durations pinned at 0.08 s a token the lead against
   the bucketed path on the kept audio (1e-4), and at 0.5 s a token the
   overflow's fallback to the bucketed path.
   d. ``wide_decoder_phase``: ``Config()`` with ``acoustic.decoder_dim``
   1024 (Tacotron 2's) and 768 on seeded weights, bf16 route: ``warmup()``,
   the lead replay against the eager program and bitwise twice, then
   counted ``synthesize`` (one lead replay: exactly one K1 launch),
   ``synthesize_batch`` on 4 texts and the whole ``stream``, every result
   checked (K1 and K2 launched, no twin).
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
   checkpoint in a second directory (both GAN runs in the sharded format,
   ``checkpoint_format="orbax"``: the raw state in ``.dcp``, the pickle the
   folded generator alone); one GAN step at a small config on the
   card against the CPU (losses and spectral ``u`` within 1e-4, TF32 off).
   The GAN-trained vocoder then serves ``SENTENCE`` with phase 4's
   duration and acoustic checkpoints on the float32, bf16 and int8 routes
   (int8 calibrated by ``warmup()``), counted: K1, K2 and K3 must launch
   and no plain twin may run; bf16 and int8 are logged against float32 on
   the same mel (rel-RMS, max abs; a few-step generator, not trained
   weights).
6. The multi-device layer on the one card: (a) in one NCCL group of one
   rank: one update of the duration and acoustic trainers at the small
   config against the same without a group (1e-6 of each leaf), then the
   duration, acoustic and GAN trainers at the
   default width on the same corpus for 2 steps each, without a process
   group and under a one-rank NCCL group joined by
   ``parallel.initialize_distributed`` (``file://`` store), with ``fsdp``
   off and (duration, acoustic) on: every loss within 1e-6 of the run
   without a group, ms/step logged beside phases 4 and 5 (TF32 off and
   deterministic algorithms in these runs), FSDP's parameters sharded at
   rest (their bytes after the run: 1/world of the split leaves, all of
   them on one rank); then, still in that group, each trainer (duration and
   acoustic with FSDP, the GAN replicated) for 2 steps in the sharded
   checkpoint format: its ``.dcp`` directory and no state pickle, restored
   into a fresh model bitwise equal to the run's final state, each
   format's save timed on that state with the bytes it wrote, and one more
   step resumed from the directory bitwise equal to the step resumed from a
   pickle of the same state; (b) ``Synthesizer(devices=
   ["cuda:0", "cuda:0"])`` with prenet dropout off on the float32, bf16
   and int8 routes against one device (float32 mels and waves within
   1e-4, bf16 and int8 waves within 1e-3 rel-RMS; K1, K2 and K3 counted,
   no plain twin), with ``synthesize_batch`` times on both, and ``serve
   --num-devices`` refusing more cards than there are; (c)
   ``tools.denoise`` over the corpus on the card against the CPU (1 LSB),
   and one duration-trainer step with ``VIETTTS_PROFILE_DIR`` set, which
   must leave a trace with device kernels; (d) ``tools.multihost_dryrun``
   as one process on the card (its own ``file://`` store): one FSDP step
   and a bitwise round trip of its sharded checkpoint.
7. The validation tools on the card (``validation_tools``):
   ``tools.validate_gan`` (30 steps, B=16, segment 8192, 48 clips),
   ``tools.validate_int8`` (``n_eval=2``) and ``tools.diagnose_int8`` on its
   checkpoint (K3 within the simulation's fault bar), and
   ``tools.validate_e2e_training`` at ``--tiny`` widths, each with the
   launch counters zeroed and read (K2; K2 and K3; K2 and K3; K1 and K2).
8. The port's benchmark programs (``viettts_tpu_torch/bench``) and F6 on
   the card: (a) ``snap_check``: after ``warmup(token_buckets=(64,))``
   (frame buckets 256 and 512), ``SENTENCE`` on the bucketed path with
   durations pinned to 300 frames (natural bucket 384) must decode the
   warmed 512, as JAX's dispatch snaps, and pinned to 600 frames (no
   warmed bucket holds it within 2x) its own 640, which joins the set, the
   frame counts read off the acoustic model's calls; (b) ``bench_phase``:
   each program's ``run()`` with PyTorch's TF32 defaults (as ``python -m``
   runs them), its JSON line printed and its launches counted (each must
   launch its kernels and no twin; K1, K2 and K3 all launch): ``e2e`` at
   ``bench.py``'s shapes (1 warm-up, 3 timed runs), ``batch`` at B=64 (1
   warm-up, 2 timed runs), ``train`` (1 warm-up and 1 timed update of 4
   steps; 1 warm-up and 2 timed GAN steps a precision), ``vocoder_batch``
   at B = 1, 8 and 64 (1 warm-up, 2 timed runs), ``b1_vocoder`` at 1,024
   frames (1 warm-up, 4 timed runs), ``stream`` (``bench_stream.py``'s
   530-token text, 1 warm-up and the best of 2 runs of each).
9. A JSON line of per-kernel results (K1, K1 at the widths 1024 and 768
   as their own entries, K2, K3, and the per-conv wgmma pipeline on each
   of its four routes as its own entry), then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero.  Without a CUDA device
it exits 1 before doing anything.
"""

from __future__ import annotations

import contextlib
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
SMALL_CARD_SMS = 114  # the H100 PCIe: K1's plan for it runs on this card too
# decoder widths whose float32 gate columns exceed the card's shared memory: K1
# streams part of them every frame (1024: Tacotron 2's decoder_rnn_dim)
K1_WIDE = {768: ((1, 512), (4, 512), (16, 512), (64, 512)),
           1024: ((1, 512), (4, 512), (16, 512), (64, 512)),
           2048: ((1, 32), (4, 32))}
WIDE_DECODERS = (1024, 768)  # phase 3d's Synthesizers
K2_F32 = dict(rtol=1e-5, atol=1e-4)
K2_BF16_REL = 0.02  # of max(|reference|, 1), the bar of tests/test_mrf.py
K2_BF16_DOTS_REL_RMS = 1e-3  # bf16 kernel vs the twin with bf16-rounded dot operands
MAIN_PATH_FRAMES = 158  # mel frames of SENTENCE at B=1 on the main path (2.53 s of audio)
BULK = (64, 768)  # (B, mel frames): bench.vocoder_batch's largest batch at its frame count
K3_REL_RMS = 1e-3
K3_MAX_REL = 0.02  # of max(|reference|, 1)
INT8_ROUTE_REL_RMS = 5e-3  # card vs CPU int8 vocoder on the same mel
INT8_VS_F32_REL_RMS = 0.05  # int8 vs float32 generator, the bar of tests/test_mrf.py
# on the CPU the lead program runs only with JAX's fused TPU routes off
LEAD_ON_CPU = ("acoustic.fused_decode=false", "hifigan.fused_inference=false")


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


def seeded(rng, *shape, scale=1.0):
    from viettts_tpu_torch.bench.seeded import seeded as draw

    return draw(rng, *shape, scale=scale)


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
    from viettts_tpu_torch.utils.flops import ar_decode_bound, device_peaks

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
        log(f"K1 ar_decode H={H} B={B} L={L}: max|kernel - twin| = {err:.3e} (atol {K1_ATOL}); "
            f"two launches bitwise equal: {torch.equal(got, again)}")
        if not err <= K1_ATOL:
            raise AssertionError(f"ar_decode H={H} B={B} L={L} differs from its twin by {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"ar_decode H={H} B={B} L={L}: two launches on the same inputs differ")
        ms = time_ms(lambda: ar_decode(*args))
        plain_ms = time_ms(lambda: ar_decode_plain(*args), reps=2)
        bound_ms, bound_by = ar_decode_bound(B, L, H, P, D, device_peaks())
        times[(B, L)] = {"ms": ms, "plain_ms": plain_ms, "us_per_frame": 1e3 * ms / L,
                         "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                         "plan": k1_plan(dev, H, P, D, B)}
        log(f"K1 ar_decode H={H} B={B} L={L}: kernel {ms:.3f} ms ({1e3 * ms / L:.2f} us/frame), twin "
            f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.2f}% of bound; "
            f"plan {times[(B, L)]['plan']}")
    return worst, times


def k1_plan(dev, H, P, D, B, sms=None):
    """K1's plan for B rows on ``sms`` SMs (the card's): grid, column
    groups, staged rows, the gate blocks streamed and their bytes a frame."""
    import torch

    from viettts_tpu_torch.ops.ar_decoder import GATE_BLOCKS, MAX_ROWS, plan_decode

    sms = sms or torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_decode(H, P, D, sms, min(B, MAX_ROWS))
    return {"sms": sms, "ctas": plan.ctas, "units": plan.units, "groups": plan.groups, "stage": plan.stage,
            "smem_bytes": plan.smem_bytes,
            "streamed": [n for i, n in enumerate(GATE_BLOCKS) if plan.streamed >> i & 1],
            "streamed_bytes_per_frame": plan.streamed_bytes_per_frame(P, H)}


def check_ar_decode_plan(dev, sms=SMALL_CARD_SMS, H=512, P=256, D=80, cases=((1, 512), (4, 512))):
    """K1 under the plan of a card with ``sms`` SMs (the H100 PCIe's 114:
    103 CTAs of 5 hidden units, the last holding 2), forced on this card
    through ``ar_decode(num_sms=...)``: against the twin within 1e-4, two
    launches bitwise equal, and its time beside this card's own plan on
    the same inputs (forced, own, forced, own; the means of each pair)."""
    import numpy as np
    import torch

    from viettts_tpu_torch.ops.ar_decoder import ar_decode, ar_decode_plain, plan_decode
    from viettts_tpu_torch.utils.flops import ar_decode_bound, device_peaks

    rng = np.random.default_rng(1)
    weights = [
        seeded(rng, D, P, scale=D ** -0.5), seeded(rng, P, P, scale=P ** -0.5),
        seeded(rng, P + H, 4 * H, scale=(P + H) ** -0.5),
        seeded(rng, P + 2 * H, 4 * H, scale=(P + 2 * H) ** -0.5),
        seeded(rng, 2 * H, D, scale=(2 * H) ** -0.5), seeded(rng, D, scale=0.1),
    ]
    weights = [torch.from_numpy(w).to(dev) for w in weights]
    own_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, times = 0.0, {}
    for B, L in cases:
        plan, own = plan_decode(H, P, D, sms, B), plan_decode(H, P, D, own_sms, B)
        g1c, g2c = (torch.from_numpy(seeded(rng, B, L, 4 * H, scale=0.5)).to(dev) for _ in range(2))
        keep1, keep2 = (torch.from_numpy(rng.random((L, B, P)) < 0.5).to(dev) for _ in range(2))
        args = (g1c, g2c, keep1, keep2, *weights, 2.0)
        got = ar_decode(*args, num_sms=sms)
        again = ar_decode(*args, num_sms=sms)
        want = ar_decode_plain(*args)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        bitwise = torch.equal(got, again)
        log(f"K1 ar_decode under the {sms}-SM plan ({plan.ctas} CTAs x {plan.units} units in {plan.groups} "
            f"groups, {plan.stage} staged rows, streamed blocks {plan.streamed:#07b}, {plan.smem_bytes} B) H={H} "
            f"B={B} L={L}: max|kernel - twin| = {err:.3e} (atol {K1_ATOL}); two launches bitwise equal: {bitwise}")
        if not err <= K1_ATOL:
            raise AssertionError(f"ar_decode ({sms}-SM plan) B={B} L={L} differs from its twin by {err}")
        if not bitwise:
            raise AssertionError(f"ar_decode ({sms}-SM plan) B={B} L={L}: two launches on the same inputs differ")
        forced, native = [], []
        for _ in range(2):
            forced.append(time_ms(lambda: ar_decode(*args, num_sms=sms)))
            native.append(time_ms(lambda: ar_decode(*args)))
        ms, own_ms = sum(forced) / 2, sum(native) / 2
        bound_ms, bound_by = ar_decode_bound(B, L, H, P, D, device_peaks())
        times[(B, L)] = {"ms": ms, "own_plan_ms": own_ms, "ms_runs": forced, "own_plan_ms_runs": native,
                         "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                         "plan": k1_plan(dev, H, P, D, B, sms), "own_plan": k1_plan(dev, H, P, D, B, own_sms)}
        log(f"K1 ar_decode H={H} B={B} L={L}: {sms}-SM plan {ms:.3f} ms ({forced[0]:.3f}; {forced[1]:.3f}), this card's "
            f"{own_sms}-SM plan ({own.ctas} CTAs x {own.units} units) {own_ms:.3f} ms ({native[0]:.3f}; "
            f"{native[1]:.3f}); bound {bound_ms:.4f} ms ({bound_by})")
    return worst, times


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


def cudnn_mrf_ms(cfg, h, weights, reps=5):
    """The yardstick of a stage's MRF convs: its 18 convs as
    ``torch.nn.functional.conv1d`` calls (cuDNN) on the stage input h [B,
    C, L] in h's dtype, the weights cast to it, summed as one timed run
    (bf16, or float32 with TF32 off).  The port never calls this."""
    from torch.nn import functional as F

    from viettts_tpu_torch.ops.mrf import _dense

    convs = []
    for (w1, b1, w2, b2), k, dils in zip(weights, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
        for j, d in enumerate(dils):
            for w, b, dil in ((w1, b1, d), (w2, b2, 1)):
                if w is not None:
                    convs.append((_dense(w)[j].to(h.dtype).permute(2, 1, 0).contiguous(), b[j].to(h.dtype), dil, k))

    def run():
        for w, b, dil, k in convs:
            F.conv1d(h, w, b, padding=dil * (k - 1) // 2, dilation=dil)

    return time_ms(run, reps)


def check_fused_mrf(dev, cfg, cases=((2, 128), (2, 100), (1, MAIN_PATH_FRAMES)),
                    timed_cases=((2, 128), (1, MAIN_PATH_FRAMES))):
    """K2 against its twins at every stage of each (B, frames) case,
    ResBlock1 and ResBlock2, float32 and bfloat16; ResBlock1 stages timed
    at (2, 128) and at the main path's B=1 frame count."""
    import numpy as np
    import torch

    from viettts_tpu_torch.ops.mrf import fused_mrf, fused_mrf_plain
    from viettts_tpu_torch.utils.flops import device_peaks, mrf_flop, stage_shapes

    peaks = device_peaks()
    rng = np.random.default_rng(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0, "bf16_dots_rel_rms": 0.0}
    # times[dtype][(B, T)] = per stage [kernel ms, twin ms, MRF-only kernel ms, MRF TFLOP/s,
    #                                    cuDNN MRF convs ms]
    times = {torch.float32: {}, torch.bfloat16: {}}
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    for dtype in (torch.float32, torch.bfloat16):
        peak = (peaks.bf16 if dtype == torch.bfloat16 else peaks.tf32) / 1e12
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
                        lib_ms = cudnn_mrf_ms(cfg, h.transpose(1, 2).contiguous(), w)
                        times[dtype].setdefault((B, T), []).append([ms, plain_ms, mrf_ms, rate, lib_ms])
                        log(f"{tag}: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms; MRF convs alone "
                            f"{mrf_ms:.3f} ms = {rate:.1f} TFLOP/s ({100 * rate / peak:.1f}% of the "
                            f"{peak:.0f} TFLOP/s dense {'bf16' if dtype == torch.bfloat16 else 'TF32'} peak); "
                            f"cuDNN conv1d of the 18 MRF convs {lib_ms:.3f} ms")
        for (B, T), rows in times[dtype].items():
            log(f"K2 fused_mrf {str(dtype)[6:]} B={B} {T} frames, 4 stages: kernel "
                f"{sum(r[0] for r in rows):.3f} ms, twin {sum(r[1] for r in rows):.3f} ms")
    return worst, times


def check_bulk(dev, cfg, reps=3):
    """K2 (bf16, float32) and K3 (static and dynamic int8) on the MRF convs
    of every default stage at the bulk shape (``BULK``: B=64, 768 mel
    frames), each stage alone: the kernel's time, the cuDNN conv1d time of
    the stage's 18 convs (bf16; float32 with TF32 off; the int8 route has
    none), the MRF-only roofline bound and the issued TFLOP/s or TOP/s.
    The stages that the per-conv wgmma pipeline takes on each route (bf16
    and static int8 at C = 256 and 128; float32 and dynamic int8 at every
    width: ``mrf.conv_takes``) are also timed on ``mma_conv_kernel``
    (``mrf.CONV_WGMMA`` off) beside it, and their twins timed once.  Every
    stage of every route is held to its twin at the phase's bars (bf16 and
    static int8 at C = 64 and 32 on the fused pipeline, one launch for the
    stage): float32 rtol 1e-5 + atol 1e-4, bf16 rel-RMS 1e-3 against the
    bf16-operand twin and 0.02 of the output scale, int8 (static and
    dynamic) bitwise."""
    import numpy as np
    import torch

    from viettts_tpu_torch.ops import mrf
    from viettts_tpu_torch.ops.mrf import fused_mrf, fused_mrf_plain, mrf_walk, prepare_mrf_weights
    from viettts_tpu_torch.utils.flops import device_peaks, mrf_issued_flops, mrf_stage_bound, stage_shapes

    peaks = device_peaks()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(5)
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    B, T = BULK
    out = {r: {"stages_ms": [], "library_stages_ms": [], "bound_stages_ms": [], "issued_flop": 0,
               "max_abs_err": 0.0, "rel_rms": 0.0, "wgmma": {}}
           for r in ("bfloat16", "float32", "int8", "int8_dynamic")}
    for i, (C_in, C, k_u, u, L_in, post) in enumerate(stage_shapes(cfg, T)):
        L = L_in * u
        w32, ups32, _ = stage_weights(rng, dev, cfg, C_in, C, k_u, u, False, False, torch.float32)
        h32 = torch.from_numpy(seeded(rng, B, L, C)).to(dev)
        for route in out:
            wgmma = mrf.conv_takes(mrf.conv_route_name(route.removesuffix("_dynamic"), route == "int8"), B, L, C)
            if route.startswith("int8"):
                dtype, h = torch.bfloat16, h32.to(torch.bfloat16)
                act = None
                if route == "int8":
                    _, amax = mrf_walk(h.float().transpose(1, 2), w32, ks, ds, lambda j, y: y.abs().amax())
                    act = torch.stack(amax)
                w, _, _ = prepare_mrf_weights(w32, quantize_int8=True)
                kw = dict(compute_dtype=dtype, quantize_int8=True, act_scales=act)
            else:
                dtype = torch.bfloat16 if route == "bfloat16" else torch.float32
                h = h32.to(dtype)
                w, _, _ = prepare_mrf_weights(w32, compute_dtype=dtype)
                kw = dict(compute_dtype=dtype)
            r = out[route]
            r["stages_ms"].append(time_ms(lambda: fused_mrf(h, w, ks, ds, **kw), reps))
            r["library_stages_ms"].append(
                None if route.startswith("int8") else cudnn_mrf_ms(cfg, h.transpose(1, 2).contiguous(), w, reps))
            bound_route = "int8" if route.startswith("int8") else route
            r["bound_stages_ms"].append(mrf_stage_bound(cfg, B, L, C, bound_route, peaks)[0])
            r["bound_by"] = mrf_stage_bound(cfg, B, L, C, bound_route, peaks)[1]
            r["issued_flop"] += mrf_issued_flops(cfg, B, L, C, bound_route, sms, route == "int8")
            if wgmma:  # the same stage on mma_conv_kernel, the pipeline it replaces
                mrf.CONV_WGMMA = False
                try:
                    per_conv = time_ms(lambda: fused_mrf(h, w, ks, ds, **kw), reps)
                finally:
                    mrf.CONV_WGMMA = True
                r["wgmma"][C] = {"ms": r["stages_ms"][-1], "per_conv_ms": per_conv,
                                 "library_ms": r["library_stages_ms"][-1],
                                 "cudnn_bf16_ms": out["bfloat16"]["library_stages_ms"][i],
                                 "bound_ms": r["bound_stages_ms"][-1], "bound_by": r["bound_by"],
                                 "issued_flop": mrf_issued_flops(cfg, B, L, C, bound_route, sms, route == "int8")}
                lib = "cuDNN float32" if route == "float32" else "cuDNN bf16"
                lib_ms = r["library_stages_ms"][-1] if route == "float32" else r["wgmma"][C]["cudnn_bf16_ms"]
                log(f"bulk B={B} {T} frames stage {i} (C={C}) {route}: per-conv wgmma {r['stages_ms'][-1]:.3f} ms, "
                    f"mma_conv_kernel {per_conv:.3f} ms, {lib} {lib_ms:.3f} ms, bound "
                    f"{r['bound_stages_ms'][-1]:.3f} ms ({r['bound_by']})")
            # every stage of every route against its twin
            got = fused_mrf(h, w, ks, ds, **kw).float()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = fused_mrf_plain(h, w, ks, ds, bf16_dots=route == "bfloat16", **kw).float()
            end.record()
            torch.cuda.synchronize()
            if wgmma:
                r["wgmma"][C]["plain_ms"] = start.elapsed_time(end)
            err, rel = (got - want).abs().max().item(), rel_rms(got, want)
            r["max_abs_err"], r["rel_rms"] = max(r["max_abs_err"], err), max(r["rel_rms"], rel)
            if route == "float32":
                ok = bool(((got - want).abs() <= K2_F32["atol"] + K2_F32["rtol"] * want.abs()).all())
            elif route == "bfloat16":
                ok = rel <= K2_BF16_DOTS_REL_RMS and err <= K2_BF16_REL * max(want.abs().max().item(), 1.0)
            else:
                ok = err == 0.0
            if wgmma:
                r["wgmma"][C].update(max_abs_err=err, rel_rms=rel)
            log(f"bulk B={B} {T} frames stage {i} (C={C}, L={L}) {route}: max|kernel - twin| {err:.3e}, "
                f"rel-RMS {rel:.2e}")
            if not ok:
                raise AssertionError(f"bulk stage {i} {route} differs from its twin: max {err}, rel-RMS {rel}")
            del got, want
            log(f"bulk B={B} {T} frames stage {i} (C={C}) {route}: kernel {r['stages_ms'][-1]:.3f} ms, "
                f"cuDNN {r['library_stages_ms'][-1]}, bound {r['bound_stages_ms'][-1]:.3f} ms")
        del h32
        torch.cuda.empty_cache()
    for route, r in out.items():
        r["ms"] = sum(r["stages_ms"])
        r["library_ms"] = None if route.startswith("int8") else sum(r["library_stages_ms"])
        r["bound_ms"] = sum(r["bound_stages_ms"])
        r["issued_tflops"] = r["issued_flop"] / r["ms"] / 1e9
        log(f"bulk B={B} {T} frames, 4 stages' MRF convs {route}: kernel {r['ms']:.3f} ms, cuDNN "
            f"{r['library_ms']}, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), issued "
            f"{r['issued_tflops']:.1f} T(FL)OP/s")
    return out


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
    from viettts_tpu_torch.utils.flops import device_peaks, mrf_flop, stage_shapes

    int8_peak = device_peaks().int8 / 1e12
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
                        f"{row['mrf_tops']:.1f} TOP/s ({100 * row['mrf_tops'] / int8_peak:.1f}% of "
                        f"the {int8_peak:.0f} TOP/s dense int8 peak), dynamic {row['mrf_ms_dynamic']:.3f} ms; "
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


def seeded_variables(cfg, seed=0):
    from viettts_tpu_torch.bench.seeded import seeded_variables as variables

    return variables(cfg, seed)


def write_checkpoints(cfg, d: Path) -> None:
    from viettts_tpu_torch.bench.seeded import write_checkpoints as write

    write(cfg, d)


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
        mfu = batch_mfu(cfg, synth, results, float(np.median(walls)), route)
        stats[route] = {"b1_latency_s": b1, "b1_audio_s": len(res.wave) / sr,
                        "b4_s_audio_per_s": b4, "b4_audio_s": audio_s, "b4_mfu": mfu}
        log(f"main path {route}: B=1 latency {b1 * 1e3:.1f} ms for {len(res.wave) / sr:.2f} s of audio "
            f"(the lead program: one CUDA graph replay); "
            f"batch-4 throughput {b4:.1f} s-audio/s ({audio_s:.2f} s of audio); {mfu['flops'] / 1e9:.2f} GFLOP, "
            f"{mfu['tflops_per_sec']:.3f} TFLOP/s, MFU {mfu['mfu']:.2e} of the {mfu['mfu_peak']} peak")
    return stats


def batch_mfu(cfg, synth, results, seconds, route):
    """MFU of one ``synthesize_batch`` of ``BATCH_TEXTS`` taking ``seconds``:
    the pipeline's FLOPs (``utils.flops.pipeline_flops``, each text at its
    own tokens and frames) against the peak of the route's compute."""
    from viettts_tpu_torch.utils.flops import mfu_report, pipeline_flops

    flop = sum(pipeline_flops(cfg, len(synth.text_to_token_ids(t)), r.mel.shape[0])
               for t, r in zip(BATCH_TEXTS, results))
    return mfu_report(flop, seconds, compute_dtype=route)


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
    mfu = batch_mfu(cfg, synth, results, float(np.median(walls)), "int8")
    log(f"main path int8: batch-4 {mfu['flops'] / 1e9:.2f} GFLOP, {mfu['tflops_per_sec']:.3f} TFLOP/s, "
        f"MFU {mfu['mfu']:.2e} of the {mfu['mfu_peak']} peak")
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
             "b4_s_audio_per_s": audio_s / float(np.median(walls)), "b4_audio_s": audio_s, "b4_mfu": mfu,
             "warmup_s": warmup_s, "stream_chunks": len(chunks), "stream_first_chunk_s": first_s,
             "stream_first_chunk_samples_s": firsts, "stream_total_s": stream_s,
             "stream_audio_s": sum(len(c.wave) for c in chunks) / sr}
    log(f"main path int8: B=1 latency {stats['b1_latency_s'] * 1e3:.1f} ms for {stats['b1_audio_s']:.2f} s of audio "
        f"and stream chunk 0 through the lead program (one CUDA graph replay); "
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

    # the fused TPU flags off: the CPU then takes the lead program too (the
    # card always does), so both sides run the same path
    cfg = apply_overrides(
        cfg.replace(ckpt_dir=ckpt_dir),
        ["hifigan.inference_dtype=int8", "acoustic.prenet_dropout_at_inference=false", *LEAD_ON_CPU],
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
    (plain twins) on one short text, both through the lead program (the
    card's a graph replay, the CPU's eager)."""
    import numpy as np

    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    cfg = apply_overrides(
        cfg.replace(ckpt_dir=ckpt_dir),
        ["hifigan.inference_dtype=float32", "acoustic.prenet_dropout_at_inference=false", *LEAD_ON_CPU],
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
# Phase 3c: the single-dispatch lead program (one CUDA graph replay)
# ---------------------------------------------------------------------------

LEAD_PINNED_S = 0.08  # seconds a token: durations pinned for lead against bucketed, as JAX's test pins them
LEAD_OVERFLOW_S = 0.5  # seconds a token: SENTENCE then overflows the lead's frame budget
LEAD_ATOL = 1e-4  # lead against bucketed on the kept audio, float32 route
LEAD_F32_REL = 1e-5  # graph replay against the eager lead program, float32 route, of max(|wave|, 1)
LEAD_COUNTED = 3  # replays whose launches are counted exactly


def _lead_inputs(synth, text):
    """The lead program's host inputs for ``text``: its row, token bucket,
    frame budget and (tokens, lengths, sil_dur)."""
    import torch

    from viettts_tpu_torch.infer.pipeline import LEAD_FRAMES_PER_TOKEN, _bucket_frames, _bucket_tokens

    row = synth.text_to_token_ids(text)
    T = _bucket_tokens(len(row), synth.token_buckets)
    toks = torch.zeros(1, T, dtype=torch.long)
    toks[0, :len(row)] = torch.tensor(row)
    inputs = (toks, torch.tensor([len(row)]), torch.tensor(-1.0))
    return row, T, _bucket_frames(T * LEAD_FRAMES_PER_TOKEN), inputs


def lead_replay_vs_eager(synth, text=SENTENCE):
    """Two replays of the lead graph of ``text``'s bucket (capturing it if
    needed) against one eager run of the lead program on the same inputs,
    on the synthesizer's route: the wave within the route's card bar
    (float32 ``LEAD_F32_REL``; bf16 K2's and int8 K3's 0.02 of scale,
    int8 also ``INT8_ROUTE_REL_RMS``), the two replays bitwise equal."""
    import torch

    row, T, n_frames, inputs = _lead_inputs(synth, text)
    with torch.inference_mode():
        first = synth._lead_replay(T, n_frames, [t.pin_memory() for t in inputs])
        second = synth._lead_replay(T, n_frames, [t.pin_memory() for t in inputs])
        with torch.cuda.device(synth.device):
            eager = [t.cpu() for t in synth._lead_program(*(t.to(synth.device) for t in inputs), n_frames)]
    names = ("wave", "mel", "durations", "total_frames")
    bitwise = all(torch.equal(a, b) for a, b in zip(first, second))
    errs = {f"{k}_max_abs": float((a - b).abs().max()) for k, a, b in zip(names, first, eager)}
    errs["wave_rel_rms"] = rel_rms(first[0], eager[0])
    scale = max(float(eager[0].abs().max()), 1.0)
    route = "int8" if synth.vocoder_quant else "float32" if synth.vocoder_dtype == torch.float32 else "bfloat16"
    if route == "float32":
        ok = errs["wave_max_abs"] <= LEAD_F32_REL * scale
    elif route == "bfloat16":
        ok = errs["wave_max_abs"] <= K2_BF16_REL * scale
    else:
        ok = errs["wave_max_abs"] <= K3_MAX_REL * scale and errs["wave_rel_rms"] <= INT8_ROUTE_REL_RMS
    log(f"lead program ({route}): bucket {T} tokens, {n_frames} frames; replay vs eager "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f"; two replays bitwise equal: {bitwise}")
    if not ok:
        raise AssertionError(f"lead program ({route}): the graph replay differs from the eager program: {errs}")
    if not bitwise:
        raise AssertionError(f"lead program ({route}): two replays on the same inputs differ")
    return {**errs, "bitwise_replays": bitwise, "tokens": len(row), "bucket": T, "frames": n_frames}


def _pin_durations(synth, seconds):
    import torch

    synth.duration_model = lambda batch, **_: torch.full(
        batch.phonemes.shape, seconds, device=batch.phonemes.device)


def lead_vs_bucketed(cfg, ckpt_dir: Path, device="cuda"):
    """float32, prenet dropout off, durations pinned at ``LEAD_PINNED_S``:
    the lead program (a graph replay) against the bucketed path on the
    kept audio of ``SENTENCE`` (within ``LEAD_ATOL``, durations equal);
    then at ``LEAD_OVERFLOW_S`` the lead overflows its frame budget and
    returns None, and ``synthesize`` takes the bucketed path."""
    import numpy as np

    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    cfg = apply_overrides(cfg.replace(ckpt_dir=ckpt_dir), [
        "hifigan.inference_dtype=float32", "acoustic.prenet_dropout_at_inference=false"])
    synth = Synthesizer(cfg, device=device)
    _pin_durations(synth, LEAD_PINNED_S)
    row = synth.text_to_token_ids(SENTENCE)
    lead = synth._synthesize_single_fused(row, -1.0)
    bucketed = synth._synthesize_rows([row])[0]
    if lead is None or lead.wave.shape != bucketed.wave.shape:
        raise AssertionError(f"lead vs bucketed: {None if lead is None else lead.wave.shape} vs {bucketed.wave.shape}")
    errs = {"wave_max_abs": float(np.abs(lead.wave - bucketed.wave).max()),
            "mel_max_abs": float(np.abs(lead.mel - bucketed.mel).max()),
            "durations_max_abs": float(np.abs(lead.durations - bucketed.durations).max())}
    over = Synthesizer(cfg, device=device)
    _pin_durations(over, LEAD_OVERFLOW_S)
    fell_back = over._synthesize_single_fused(row, -1.0) is None
    got, want = over.synthesize(SENTENCE), over._synthesize_rows([row])[0]
    errs["overflow_wave_max_abs"] = float(np.abs(got.wave - want.wave).max()) if got.wave.shape == want.wave.shape \
        else float("inf")
    log(f"lead vs bucketed (float32, {LEAD_PINNED_S} s a token, {lead.mel.shape[0]} kept frames): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; at {LEAD_OVERFLOW_S} s a token the lead returned None: {fell_back} ({got.mel.shape[0]} frames bucketed)")
    if not (errs["wave_max_abs"] <= LEAD_ATOL and errs["mel_max_abs"] <= LEAD_ATOL and errs["durations_max_abs"] == 0):
        raise AssertionError(f"lead program differs from the bucketed path on the kept audio: {errs}")
    if not fell_back or not errs["overflow_wave_max_abs"] <= 1e-5:
        raise AssertionError(f"an overflowing row did not fall back to the bucketed path: {errs}")
    return errs


def graph_pool_bytes(synth):
    """Bytes of the segments the lead graphs' shared memory pool holds on
    the card (from ``torch.cuda.memory_snapshot``), None where the
    snapshot does not name pools."""
    import torch

    pool = synth._graph_pool
    segs = torch.cuda.memory_snapshot()
    if pool is None or not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(pool))


def lead_timings(synth, reps=3):
    """B=1 latency of ``synthesize(SENTENCE)`` and time to first audio of
    ``stream(STREAM_TEXT)`` (the whole stream consumed), with the lead
    program and with ``single_dispatch_max_tokens = 0`` (bucketed), in
    turns, after one untimed call of each; medians of ``reps``."""
    import numpy as np

    def once():
        t0 = time.perf_counter()
        check_result(synth.synthesize(SENTENCE), "synthesize (lead timing)")
        b1 = time.perf_counter() - t0
        t0, first = time.perf_counter(), None
        for chunk in synth.stream(STREAM_TEXT):
            first = first or time.perf_counter() - t0
        return b1, first

    runs = {"lead": [], "bucketed": []}
    gate = synth.single_dispatch_max_tokens
    try:
        for i in range(reps + 1):
            for mode in runs:
                synth.single_dispatch_max_tokens = gate if mode == "lead" else 0
                b1, first = once()
                if i:
                    runs[mode].append((b1, first))
    finally:
        synth.single_dispatch_max_tokens = gate
    return {mode: {"b1_latency_s": float(np.median([r[0] for r in v])), "b1_runs_s": [r[0] for r in v],
                   "first_audio_s": float(np.median([r[1] for r in v])), "first_audio_runs_s": [r[1] for r in v]}
            for mode, v in runs.items()}


def lead_phase(cfg, ckpt_dir: Path, zero, read, device="cuda"):
    """Phase 3c, on the bf16, float32 and int8 routes at the default width:
    ``warmup()`` captures one lead graph per token bucket of at most 64
    tokens (seconds per bucket, bytes of the shared pool); the replay
    against the eager program and two replays bitwise
    (``lead_replay_vs_eager``); ``LEAD_COUNTED`` replays of
    ``synthesize(SENTENCE)`` with the counters zeroed, which must count
    exactly one K1 launch and four vocoder-stage launches (K2, and K3 on
    the int8 route) a replay and no twin; then ``lead_timings``, counted
    (``read``); and ``lead_vs_bucketed`` on the float32 route."""
    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer
    from viettts_tpu_torch.ops.ar_decoder import ar_decode
    from viettts_tpu_torch.ops.mrf import fused_mrf

    out = {}
    for route in ("bfloat16", "float32", "int8"):
        synth = Synthesizer(apply_overrides(cfg.replace(ckpt_dir=ckpt_dir), [f"hifigan.inference_dtype={route}"]),
                            device=device)
        t0 = time.perf_counter()
        synth.warmup()
        warmup_s = time.perf_counter() - t0
        want = [b for b in synth.token_buckets if b <= synth.single_dispatch_max_tokens]
        if sorted(synth.lead_graphs) != want:
            raise AssertionError(f"lead program ({route}): warmup captured buckets {sorted(synth.lead_graphs)}, "
                                 f"want {want}")
        capture_s = {T: g.capture_s for T, g in sorted(synth.lead_graphs.items())}
        pool = graph_pool_bytes(synth)
        log(f"lead program ({route}): warmup {warmup_s:.2f} s; eager run + capture per token bucket "
            + ", ".join(f"{T}: {v:.3f} s" for T, v in capture_s.items())
            + f"; graph pool {'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'}")
        stats = {"warmup_s": warmup_s, "capture_s": capture_s, "pool_bytes": pool,
                 "replay_vs_eager": lead_replay_vs_eager(synth)}
        zero()
        for _ in range(LEAD_COUNTED):
            check_result(synth.synthesize(SENTENCE), f"synthesize ({route}, lead)")
        int8 = route == "int8"
        counted = (ar_decode.launches, ar_decode.plain_calls, fused_mrf.launches, fused_mrf.int8_launches,
                   fused_mrf.plain_calls, fused_mrf.conv_launches, fused_mrf.int8_conv_launches,
                   fused_mrf.tf32_conv_launches, fused_mrf.int8_dynamic_conv_launches)
        # the 512-frame lead's stages on the per-conv wgmma pipeline: C = 256 and 128 on the bf16 and
        # calibrated int8 routes, all four on the float32 route
        want = (LEAD_COUNTED, 0, 4 * LEAD_COUNTED, 4 * LEAD_COUNTED if int8 else 0, 0,
                2 * LEAD_COUNTED if route == "bfloat16" else 0, 2 * LEAD_COUNTED if int8 else 0,
                4 * LEAD_COUNTED if route == "float32" else 0, 0)
        log(f"lead program ({route}): {LEAD_COUNTED} replays counted (K1, K1 twin, K2, K3, K2/K3 twin, "
            f"their wgmma stages bf16, int8, tf32, int8 dynamic) {counted}, want {want}")
        if counted != want:
            raise AssertionError(f"lead program ({route}): replays counted {counted}, want {want}")
        zero()
        stats["timings"] = t = lead_timings(synth)
        stats["launches"] = read(f"lead program ({route})",
                                 ["ar_decode", "fused_mrf"] + (["fused_mrf_int8", "mrf_conv_wgmma_int8"] if int8 else [])
                                 + (["mrf_conv_wgmma"] if route == "bfloat16" else [])
                                 + (["mrf_conv_wgmma_tf32"] if route == "float32" else []))
        log(f"lead program ({route}): B=1 latency of SENTENCE lead {1e3 * t['lead']['b1_latency_s']:.1f} ms "
            f"{[round(1e3 * v, 1) for v in t['lead']['b1_runs_s']]}, bucketed "
            f"{1e3 * t['bucketed']['b1_latency_s']:.1f} ms {[round(1e3 * v, 1) for v in t['bucketed']['b1_runs_s']]}; "
            f"first audio of STREAM_TEXT lead {1e3 * t['lead']['first_audio_s']:.1f} ms "
            f"{[round(1e3 * v, 1) for v in t['lead']['first_audio_runs_s']]}, bucketed "
            f"{1e3 * t['bucketed']['first_audio_s']:.1f} ms "
            f"{[round(1e3 * v, 1) for v in t['bucketed']['first_audio_runs_s']]} (medians of 3, in turns)")
        out[route] = stats
    out["lead_vs_bucketed"] = lead_vs_bucketed(cfg, ckpt_dir, device)
    return out


def wide_decoder_phase(cfg, tmp: Path, zero, read, width, device="cuda"):
    """Phase 3d: ``Config()`` with ``acoustic.decoder_dim = width``
    (Tacotron 2's 1024, or 768: widths whose float32 gate columns K1
    cannot hold in the card's shared memory, so its plan streams some
    every frame) on seeded
    weights written as native checkpoints, on the default bf16 route:
    ``warmup()`` (the lead graphs' captures), the lead replay against the
    eager program and two replays bitwise (``lead_replay_vs_eager``), then
    with the counters zeroed ``synthesize(SENTENCE)`` (one lead replay,
    exactly one K1 launch), ``synthesize_batch(BATCH_TEXTS)`` (the
    bucketed path) and the whole ``stream(STREAM_TEXT)``, every result
    checked; K1 and K2 must launch and no twin run."""
    import numpy as np

    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer
    from viettts_tpu_torch.ops.ar_decoder import ar_decode

    t_phase = time.perf_counter()
    wcfg = apply_overrides(cfg, [f"acoustic.decoder_dim={width}"])
    ckpt = tmp / f"decoder_{width}"
    ckpt.mkdir()
    write_checkpoints(wcfg, ckpt)
    synth = Synthesizer(wcfg.replace(ckpt_dir=ckpt), device=device)
    t0 = time.perf_counter()
    synth.warmup()
    out = {"decoder_dim": width, "warmup_s": time.perf_counter() - t0, "lead_buckets": sorted(synth.lead_graphs),
           "replay_vs_eager": lead_replay_vs_eager(synth)}
    zero()
    t0 = time.perf_counter()
    res = synth.synthesize(SENTENCE)
    out["b1_latency_s"] = time.perf_counter() - t0
    check_result(res, f"synthesize (decoder_dim={width}, lead)")
    if (ar_decode.launches, ar_decode.plain_calls) != (1, 0):
        raise AssertionError(f"decoder_dim={width}: the lead replay counted {ar_decode.launches} K1 launches and "
                             f"{ar_decode.plain_calls} twin calls, want (1, 0)")
    t0 = time.perf_counter()
    results = synth.synthesize_batch(BATCH_TEXTS)
    out["b4_s"] = time.perf_counter() - t0
    for i, r in enumerate(results):
        check_result(r, f"synthesize_batch[{i}] (decoder_dim={width})")
    t0 = time.perf_counter()
    chunks = list(synth.stream(STREAM_TEXT))
    out["stream_s"], out["stream_chunks"] = time.perf_counter() - t0, len(chunks)
    for i, c in enumerate(chunks):
        check_result(c, f"stream chunk {i} (decoder_dim={width})")
    out["audio_s"] = {"synthesize": len(res.wave) / cfg.dsp.sample_rate,
                      "synthesize_batch": sum(len(r.wave) for r in results) / cfg.dsp.sample_rate,
                      "stream": float(np.sum([len(c.wave) for c in chunks])) / cfg.dsp.sample_rate}
    out["launches"] = read(f"decoder_dim={width} (bf16: lead, synthesize_batch, stream)",
                           ["ar_decode", "fused_mrf", "mrf_conv_wgmma"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 3d, decoder_dim={width}: warmup {out['warmup_s']:.2f} s (lead buckets {out['lead_buckets']}); "
        f"B=1 lead {1e3 * out['b1_latency_s']:.1f} ms for {out['audio_s']['synthesize']:.2f} s of audio; "
        f"synthesize_batch {1e3 * out['b4_s']:.1f} ms; stream {len(chunks)} chunks in {out['stream_s']:.2f} s; "
        f"phase {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 4: the training slice
# ---------------------------------------------------------------------------

CORPUS_UTTERANCES = 96  # 91 train / 5 val at train_split 0.95: one batch of 64
DURATION_STEPS, ACOUSTIC_STEPS = 20, 6
TRAIN_REL = 1e-4  # card against CPU, one step, of each leaf's largest value


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
    from viettts_tpu_torch.utils.flops import acoustic_step_flop, device_peaks, duration_step_flop

    fp32 = device_peaks().fp32
    flop = duration_step_flop(cfg) if name == "duration" else acoustic_step_flop(cfg)
    bound_ms = 1e3 * flop / fp32
    stats = {"steps": len(steps), "first_step_ms": ms[0], "median_ms": float(np.median(ms[1:])),
             "ms": ms, "first_loss": losses[0], "last_loss": losses[-1],
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "flop_per_step": flop,
             "bound_ms": bound_ms, "bound_by": "operations (float32 peak)", "wall_s": wall}
    log(f"train {name}: {len(steps)} steps, first {ms[0]:.1f} ms, then median {stats['median_ms']:.1f} ms/step; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak memory {stats['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
        f"{flop / 1e12:.3f} TFLOP/step, bound {bound_ms:.1f} ms at {fp32 / 1e12:.0f} TFLOP/s "
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

    from viettts_tpu_torch.tools.synth_corpus import build_corpus
    from viettts_tpu_torch.train import acoustic, duration

    corpus, out = tmp / "corpus", tmp / "trained"
    t0 = time.perf_counter()
    build_corpus(corpus, CORPUS_UTTERANCES)
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


GAN_STEPS, GAN_CKPT_INTERVAL, GTA_STEPS = 6, 3, 2


def run_gan(name, cfg, steps, **kw):
    """``train.hifigan.train`` to ``steps`` on the card: per-step ms and
    losses (each step waits for the device), peak memory, FLOPs and their
    bound at the float32 and TF32 peaks."""
    import numpy as np
    import torch

    from viettts_tpu_torch.train import hifigan
    from viettts_tpu_torch.utils.flops import device_peaks, gan_step_flop

    log_ = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hifigan.train(cfg, num_steps=steps, device="cuda", step_log=log_, log_every=GAN_CKPT_INTERVAL, **kw)
    wall = time.perf_counter() - t0
    ms = [1e3 * s for s, _ in log_]
    losses = {k: [m[k] for _, m in log_] for k in ("disc_loss", "gen_loss", "mel_l1", "adv", "fm")}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"GAN {name}: non-finite loss {losses}")
    peaks = device_peaks()
    flop = gan_step_flop(cfg)
    median = float(np.median(ms[1:])) if len(ms) > 1 else ms[0]
    stats = {"steps": len(ms), "first_step_ms": ms[0], "median_ms": median, "ms": ms,
             "first": {k: v[0] for k, v in losses.items()}, "last": {k: v[-1] for k, v in losses.items()},
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "flop_per_step": flop,
             "bound_ms_f32": 1e3 * flop / peaks.fp32, "bound_ms_tf32": 1e3 * flop / peaks.tf32,
             "wall_s": wall}
    log(f"GAN {name}: {len(ms)} steps, first {ms[0]:.1f} ms, then median {median:.1f} ms/step; "
        + "; ".join(f"{k} {losses[k][0]:.4f} -> {losses[k][-1]:.4f}" for k in ("disc_loss", "gen_loss", "mel_l1"))
        + f"; peak memory {stats['max_memory_allocated_bytes'] / 2**30:.2f} GiB; {flop / 1e12:.3f} TFLOP/step, "
        f"bound {stats['bound_ms_f32']:.1f} ms at {peaks.fp32 / 1e12:.0f} TFLOP/s f32, "
        f"{stats['bound_ms_tf32']:.1f} ms at {peaks.tf32 / 1e12:.0f} TF32; {wall:.1f} s in all")
    return stats


def gan_phase(cfg, corpus: Path, trained: Path, tmp: Path):
    """The vocoder half of the recipe on the card, TF32 on in cuDNN as in
    the train phase: silence zeroing, 6 GAN steps (audio only) with a
    checkpoint every 3, the GTA export from the trained acoustic model, and
    2 GTA steps resuming that checkpoint in a second directory.  Both GAN
    runs use the sharded checkpoint format (``checkpoint_format="orbax"``):
    the raw state in ``hifigan_latest_ckpt.dcp``, the pickle holding the
    folded generator alone.  Returns the stats and the GAN-trained vocoder
    checkpoint (that pickle)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from viettts_tpu_torch.checkpoint import load_pickle
    from viettts_tpu_torch.tools import gta, zero_silence_segments
    from viettts_tpu_torch.train.checkpoint import sharded_dir

    wavs, gta_dir, audio_dir, ft_dir = tmp / "wavs_zeroed", tmp / "gta", tmp / "gan", tmp / "gan_gta"
    zero_silence_segments.main(["-i", str(corpus), "-o", str(wavs)])
    base = cfg.replace(train=dataclasses.replace(cfg.train, ckpt_interval=GAN_CKPT_INTERVAL,
                                                 checkpoint_format="orbax"))
    name = "hifigan_latest_ckpt.pickle"
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
        shutil.copytree(sharded_dir(audio_dir / name), sharded_dir(ft_dir / name))
        stats["gta"] = run_gan("GTA finetune", base.replace(ckpt_dir=ft_dir), GAN_STEPS + GTA_STEPS,
                               wav_dir=wavs, gta_dir=gta_dir)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    ckpt = ft_dir / name
    dic = load_pickle(ckpt)
    if stats["gta"]["steps"] != GTA_STEPS or dic["step"] != GAN_STEPS + GTA_STEPS:
        raise AssertionError(f"GTA finetune took {stats['gta']['steps']} steps to step {dic['step']}")
    if sorted(dic) != ["format", "step", "variables"] or not sharded_dir(ckpt).is_dir():
        raise AssertionError(f"sharded GAN checkpoint: the pickle holds {sorted(dic)}, "
                             f"{sharded_dir(ckpt).name} exists: {sharded_dir(ckpt).is_dir()}")
    stats["sharded_dir_bytes"] = sum(f.stat().st_size for f in sharded_dir(ckpt).iterdir())
    stats["pickle_bytes"] = ckpt.stat().st_size
    log(f"GTA finetune resumed at step {GAN_STEPS} from {sharded_dir(ckpt).name} "
        f"({stats['sharded_dir_bytes'] / 2**30:.3f} GiB); its pickle holds the folded generator alone "
        f"({stats['pickle_bytes'] / 2**20:.1f} MiB)")
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


def _one_step(kind, cfg, batch, device, lr, data_parallel=False):
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
    update = make_update_fn(loss_fn, opt, data_parallel=data_parallel)
    state, loss = update(state, [to_device(batch, torch.device(device))])
    return float(loss), {k: v.detach().cpu() for k, v in {**state.params, **state.batch_stats}.items()}, before


def _step_difference(what, loss, params, want_loss, want, before, lr, bar):
    """The worst relative difference of one step's loss and of its
    parameters and statistics (of each leaf's largest value) from
    ``want``'s; raises above ``bar``.  A conv bias that feeds a BatchNorm
    has a zero gradient in exact arithmetic, which Adam scales to a full
    step of either sign: there each side must have moved by at most the
    learning rate."""
    import numpy as np

    worst = abs(loss - want_loss) / abs(want_loss)
    if not (np.isfinite(loss) and worst <= bar):
        raise AssertionError(f"{what}: loss {loss} against {want_loss}")
    for name, w in want.items():
        if name.endswith("bias") and "convs" in name and not name.startswith("postnet_convs.4"):
            moved = max((side - before[name]).abs().max().item() for side in (params[name], w))
            if moved > lr * 1.01:
                raise AssertionError(f"{what}: zero-gradient bias {name} moved {moved}")
            continue
        rel = (params[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        if rel > bar:
            raise AssertionError(f"{what}: {name} differs by {rel:.2e} of its largest value")
    return worst


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
    import torch

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 must be off for the card-vs-CPU step")
    cfg = _small_train_config()
    lr = 1e-4  # the trainers' default learning rate
    errs = {}
    for kind, batch in _small_train_batches().items():
        loss_card, card, before = _one_step(kind, cfg, batch, "cuda", lr)
        loss_cpu, cpu, _ = _one_step(kind, cfg, batch, "cpu", lr)
        errs[kind] = _step_difference(f"{kind} step, card vs CPU", loss_card, card, loss_cpu, cpu, before, lr,
                                      TRAIN_REL)
        log(f"train card vs CPU, {kind}: one step, worst relative difference {errs[kind]:.2e} (bar {TRAIN_REL})")
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


# ---------------------------------------------------------------------------
# Phase 6: the multi-device layer on one card
# ---------------------------------------------------------------------------

NCCL_REL = 1e-6  # one NCCL rank against no process group, every loss of every step
NCCL_STEPS = 2
# two replicas against one device on the whole batch (B=4 against 2 x B=2):
# float32 mels and waves; the bf16 and int8 waves, whose tiles (and so
# float32 sum orders) K2 picks by batch size, each run within K2's 1e-3
# rel-RMS bf16 bar per stage
REPLICA_F32_ATOL, REPLICA_REL_RMS = 1e-4, 1e-2


def _small_train_config():
    """Widths 32-64, 8 mels, every dropout and zoneout off."""
    from viettts_tpu_torch.config import AcousticModelConfig, Config, DspConfig, DurationModelConfig

    return Config(
        dsp=DspConfig(n_fft=256, hop_length=64, win_length=256, mel_dim=8),
        duration=DurationModelConfig(vocab_size=96, lstm_dim=32, dropout_rate=0.0),
        acoustic=AcousticModelConfig(vocab_size=96, encoder_dim=32, decoder_dim=64, prenet_dim=32,
                                     postnet_dim=32, mel_dim=8, encoder_dropout_rate=0.0,
                                     prenet_dropout_rate=0.0, postnet_dropout_rate=0.0,
                                     prenet_dropout_at_inference=False, zoneout_rate=0.0),
    )


def _small_train_batches():
    """The small duration and acoustic batches of ``train_card_vs_cpu``."""
    import numpy as np

    from viettts_tpu_torch.types import AcousticBatch, DurationBatch

    rng = np.random.default_rng(4)
    B, T, frames = 4, 16, 48
    lengths = np.asarray([16, 13, 9, 5], np.int32)
    toks = rng.integers(4, 96, (B, T)).astype(np.int32)
    durs = rng.uniform(0.02, 0.06, (B, T)).astype(np.float32)
    toks[:, 2] = 3
    for i, n in enumerate(lengths):
        toks[i, n:], durs[i, n:] = 0, 0.0
    wavs = (rng.standard_normal((B, frames * 64)) * 3000).astype(np.int16)
    wav_lengths = np.asarray([frames * 64, 2800, 2000, 1200], np.int32)
    return {"duration": DurationBatch(toks, lengths, durs),
            "acoustic": AcousticBatch(toks, lengths, durs, wavs, wav_lengths, None)}


@contextlib.contextmanager
def _deterministic():
    """TF32 off, cuDNN's deterministic algorithms and torch's deterministic
    algorithms (warning where an op has none), so that two runs differ only
    by the arithmetic under test; restored on exit."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    algorithms = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(algorithms[0], warn_only=algorithms[1])
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = flags


def _small_steps(device, data_parallel=False):
    """One update of the duration and acoustic trainers at the small
    config (``_one_step``), with or without ``data_parallel``."""
    cfg = _small_train_config()
    return {kind: _one_step(kind, cfg, b, device, 1e-4, data_parallel) for kind, b in _small_train_batches().items()}


def _small_step_errors(plain, ranked):
    """``_step_difference`` of each one-rank update from the update without
    a group, at ``NCCL_REL``."""
    return {kind: _step_difference(f"{kind} step, one rank vs no group", *ranked[kind][:2], loss, params,
                                   before, 1e-4, NCCL_REL)
            for kind, (loss, params, before) in plain.items()}


def nccl_step_vs_plain(store: Path, device="cuda"):
    """One update of the duration and acoustic trainers at
    ``train_card_vs_cpu``'s small config: under a one-rank group (NCCL on
    the card; ``file://`` store at ``store``; ``data_parallel=True``:
    BatchNorm's sums, the loss denominator and the gradients all-reduced)
    against no group; loss and parameters within ``NCCL_REL`` of each
    leaf's largest value (the zero-gradient conv biases as in
    ``_step_difference``), both under ``_deterministic()``.  Raises above
    the bar."""
    import torch.distributed as dist

    from viettts_tpu_torch.parallel import mesh

    with _deterministic():
        plain = _small_steps(device)
        mesh.initialize_distributed(f"file://{store}", 1, 0, device=device)
        try:
            ranked = _small_steps(device, data_parallel=True)
        finally:
            dist.destroy_process_group()
    return _small_step_errors(plain, ranked)


def _train(kind, cfg, wav_dir, device):
    """One trainer run on the card to ``cfg.train.num_training_steps``: its
    final state, each step's ms and its losses (every metric of the GAN
    step)."""
    from viettts_tpu_torch.train import acoustic, duration, hifigan

    steps = []
    if kind == "gan":
        state = hifigan.train(cfg, wav_dir=wav_dir, log_every=NCCL_STEPS, device=device, step_log=steps)
        losses = [[m[k] for k in sorted(m)] for _, m in steps]
    else:
        module = duration if kind == "duration" else acoustic
        state = module.train(cfg, save_plots=False, device=device, step_log=steps)
        losses = [[loss] for _, loss in steps]
    return state, [1e3 * s for s, _ in steps], losses


def _losses(kind, cfg, wav_dir, device):
    """``_train``'s ms and losses, and the bytes the parameters hold after
    the run (under FSDP: this rank's slices at rest)."""
    state, ms, losses = _train(kind, cfg, wav_dir, device)
    params = {**state.gen_params, **state.disc_params} if kind == "gan" else state.params
    return ms, losses, sum(p.untyped_storage().nbytes() for p in params.values())


CKPT_NAMES = {"duration": "duration_latest_ckpt.pickle", "acoustic": "acoustic_latest_ckpt.pickle",
              "gan": "hifigan_latest_ckpt.pickle"}


def _template(kind, cfg, device):
    """A fresh state of ``kind``'s trainer at ``cfg``, laid out as the
    trainer lays it out under this group (FSDP as ``cfg`` says), with other
    values than any trained state; and its optimizer (None for the GAN)."""
    import torch

    from viettts_tpu_torch.models.acoustic import AcousticModel
    from viettts_tpu_torch.models.duration import DurationModel
    from viettts_tpu_torch.models.layers import batch_stats
    from viettts_tpu_torch.train import hifigan
    from viettts_tpu_torch.train.common import FsdpClipAdamW, exponential_decay, init_train_state, make_optimizer

    t = cfg.train
    if kind == "gan":  # the trainer's rate is a schedule: the template needs its count
        lr = exponential_decay(cfg.hifigan.learning_rate, 1, cfg.hifigan.lr_decay, staircase=True)
        return hifigan.build_gan(cfg, device, lr, data_parallel=True)[0], None
    model = (DurationModel(cfg.duration) if kind == "duration" else AcousticModel(cfg.acoustic)).to(device)
    optimizer = make_optimizer(t.duration_learning_rate if kind == "duration" else t.learning_rate,
                               t.max_grad_norm, t.weight_decay)
    if t.fsdp:
        optimizer = FsdpClipAdamW(optimizer)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), optimizer,
                             torch.Generator(device).manual_seed(t.seed + 1))
    return state, optimizer


def _same_state(kind, a, b) -> bool:
    """Bitwise equal tensors, counts and generator state."""
    import numpy as np
    import torch

    if kind == "gan":
        trees = [(a.gen_params, b.gen_params), (a.disc_params, b.disc_params), (a.spectral, b.spectral)]
        opts = [(a.gen_opt, b.gen_opt), (a.disc_opt, b.disc_opt)]
        rng = np.array_equal(a.rng, b.rng)
    else:
        trees = [(a.params, b.params), (a.batch_stats, b.batch_stats)]
        opts = [(a.opt_state, b.opt_state)]
        rng = torch.equal(a.rng.get_state(), b.rng.get_state())
    trees += [(x.mu, y.mu) for x, y in opts] + [(x.nu, y.nu) for x, y in opts]
    return (rng and a.step == b.step
            and all((x.count, x.schedule_count) == (y.count, y.schedule_count) for x, y in opts)
            and all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x) for x, y in trees))


def _save(kind, path, state, fmt, optimizer):
    from viettts_tpu_torch.train import duration, hifigan

    if kind == "gan":
        hifigan.save_vocoder_ckpt(path, state, fmt=fmt)
    else:
        duration.save_native_ckpt(path, state, fmt, optimizer)


def _bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*")) if path.is_dir() else path.stat().st_size


def _save_costs(kind, state, optimizer, out: Path):
    """Wall ms of writing ``state`` in each format, in turns (pickle,
    sharded, sharded, pickle; each waits for its files), and the bytes
    each format wrote: the pickle, and the sharded directory beside the
    pickle that format still writes (the GAN's folded generator; none for
    the other trainers)."""
    import shutil

    from viettts_tpu_torch.train.checkpoint import sharded_dir

    ms = {"pickle": [], "orbax": []}
    written = {}
    for fmt in ("pickle", "orbax", "orbax", "pickle"):
        path = out / fmt / CKPT_NAMES[kind]
        t0 = time.perf_counter()
        _save(kind, path, state, fmt, optimizer)
        ms[fmt].append(1e3 * (time.perf_counter() - t0))
        written[fmt] = {"dir": _bytes(sharded_dir(path)) if fmt == "orbax" else 0,
                        "pickle": _bytes(path) if path.exists() else 0}
    shutil.rmtree(out)
    return {"ms": ms, "bytes": written}


def sharded_resume(kind, cfg, wav_dir, root: Path, device="cuda"):
    """Phase 6a's sharded checkpoint, for one trainer under the process
    group (duration and acoustic with ``cfg``'s FSDP, the GAN replicated):
    ``NCCL_STEPS`` steps with ``checkpoint_format="orbax"``, which must
    leave the ``.dcp`` directory and no state pickle (the GAN's pickle: the
    folded generator alone); the directory restored into a fresh state of
    another model, which must equal the run's final state bitwise; that
    restored state written as a pickle too, and each format's save timed;
    then one more step resumed from the directory and one resumed from
    that pickle, whose losses must be bitwise equal.  Both resumed runs
    restart their batch stream, as the JAX trainers do, so they see the
    same batches, which an uninterrupted run does not."""
    import dataclasses

    from viettts_tpu_torch.checkpoint import load_pickle
    from viettts_tpu_torch.train import duration, hifigan
    from viettts_tpu_torch.train.checkpoint import sharded_dir

    def run_cfg(name, fmt, steps):
        return cfg.replace(ckpt_dir=root / f"{kind}_{name}", train=dataclasses.replace(
            cfg.train, checkpoint_format=fmt, num_training_steps=steps))

    sharded = run_cfg("sharded", "orbax", NCCL_STEPS)
    state, ms, losses = _train(kind, sharded, wav_dir, device)
    path = Path(sharded.ckpt_dir) / CKPT_NAMES[kind]
    pickled = sorted(load_pickle(path)) if path.exists() else None
    if not sharded_dir(path).is_dir() or pickled != (["format", "step", "variables"] if kind == "gan" else None):
        raise AssertionError(f"sharded {kind} run: {sharded_dir(path).name} exists: {sharded_dir(path).is_dir()}; "
                             f"pickle keys {pickled}")
    template, optimizer = _template(kind, sharded, device)
    if kind == "gan":
        restored = hifigan.restore_vocoder_state(path, template, fmt="orbax")
    else:
        restored = duration.restore_state(path, optimizer, template, "orbax")
    if not _same_state(kind, restored, state):
        raise AssertionError(f"sharded {kind} checkpoint: the restored state differs from the trained one")
    via_pickle = run_cfg("sharded_pickle", "pickle", NCCL_STEPS + 1)
    _save(kind, Path(via_pickle.ckpt_dir) / CKPT_NAMES[kind], restored, "pickle", optimizer)
    costs = _save_costs(kind, restored, optimizer, root / f"{kind}_save_costs")
    del state, restored, template
    resumed = _train(kind, run_cfg("sharded", "orbax", NCCL_STEPS + 1), wav_dir, device)[2]
    reference = _train(kind, via_pickle, wav_dir, device)[2]
    if len(resumed) != 1 or resumed != reference:
        raise AssertionError(f"{kind}: the step resumed from {sharded_dir(path).name} gave {resumed}, "
                             f"from the pickle of the same state {reference}")
    return {"ms": ms, "losses": losses, "resumed_losses": resumed, "save": costs}


def _bucket_ms(kind, cfg, device):
    """Device ms (CUDA events) of one flat-bucket gradient all-reduce over
    ``kind``'s parameters, the collective a data-parallel step adds (the
    GAN step's two buckets, discriminators and generator, timed as one of
    the same bytes)."""
    import torch

    from viettts_tpu_torch.models.acoustic import AcousticModel
    from viettts_tpu_torch.models.discriminators import Discriminators
    from viettts_tpu_torch.models.duration import DurationModel
    from viettts_tpu_torch.models.hifigan import Generator
    from viettts_tpu_torch.parallel import mesh

    h = cfg.hifigan
    models = {"duration": lambda: [DurationModel(cfg.duration)], "acoustic": lambda: [AcousticModel(cfg.acoustic)],
              "gan": lambda: [Generator(h, use_wn=True), Discriminators(h.mpd_periods, h.mpd_base_channels,
                                                                        h.msd_scales, h.msd_base_channels)]}[kind]()
    grads = [torch.zeros(p.shape, device=device) for m in models for p in m.parameters()]
    return time_ms(lambda: mesh.all_reduce_grads(grads)), 4 * sum(g.numel() for g in grads)


def nccl_training(cfg, tmp: Path, earlier: dict, device="cuda"):
    """Phase 6a, in one process group (a second NCCL group in a process
    whose first was destroyed failed on the card with "NCCL communicator
    was aborted"): first ``nccl_step_vs_plain``'s small-config update,
    then the three trainers at the default width on phase 4's corpus (the
    GAN on phase 5's silence-zeroed WAVs), ``NCCL_STEPS``
    steps each with ``num_devices=1``: without a process group, then under
    a one-rank NCCL group joined through ``initialize_distributed`` with
    a ``file://`` store, with ``fsdp`` off and (duration, acoustic: the GAN
    trainer replicates, as JAX's does) on.  Every loss of every step within
    ``NCCL_REL`` of the run without a group.  All runs under
    ``_deterministic()``, so that they differ only by the data-parallel
    arithmetic (BatchNorm's sums over the ranks, the clip's norm over
    shards).  ``earlier``: phases 4 and 5's median ms/step, logged
    beside."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from viettts_tpu_torch.parallel import mesh

    root = tmp / "nccl"
    kinds = ("duration", "acoustic", "gan")

    def config(kind, mode):
        fsdp = mode == "fsdp"
        train = dataclasses.replace(cfg.train, num_training_steps=NCCL_STEPS, val_interval=NCCL_STEPS,
                                    ckpt_interval=NCCL_STEPS, num_devices=1, fsdp=fsdp)
        return cfg.replace(data_dir=tmp / "corpus", ckpt_dir=root / f"{kind}_{mode}", train=train)

    runs = {}
    with _deterministic():
        small = _small_steps(device)
        for kind in kinds:
            runs[(kind, "plain")] = _losses(kind, config(kind, "plain"), tmp / "wavs_zeroed", device)
        mesh.initialize_distributed(f"file://{tmp / 'nccl_store'}", 1, 0, device=device)
        try:
            backend, world = dist.get_backend(), mesh.world()
            small_ranked = _small_steps(device, data_parallel=True)
            for kind in kinds:
                runs[(kind, "dp")] = _losses(kind, config(kind, "dp"), tmp / "wavs_zeroed", device)
            for kind in ("duration", "acoustic"):
                runs[(kind, "fsdp")] = _losses(kind, config(kind, "fsdp"), tmp / "wavs_zeroed", device)
            buckets = {kind: _bucket_ms(kind, cfg, device) for kind in kinds}
            sharded = {kind: sharded_resume(kind, config(kind, "dp" if kind == "gan" else "fsdp"),
                                            tmp / "wavs_zeroed", root, device) for kind in kinds}
        finally:
            dist.destroy_process_group()
    if backend != ("nccl" if device == "cuda" else "gloo") or world != (0, 1):
        raise AssertionError(f"process group: {backend}, {world}")
    out = {"backend": backend, "small_step": _small_step_errors(small, small_ranked),
           "bucket": {k: {"ms": ms, "bytes": n} for k, (ms, n) in buckets.items()}, "sharded": sharded}
    log(f"{backend} one-rank update vs no group, small config: " + ", ".join(
        f"{k} {v:.2e}" for k, v in out["small_step"].items()) + f" (bar {NCCL_REL})")
    for (kind, mode), (ms, losses, resident) in runs.items():
        want = np.asarray(runs[(kind, "plain")][1])
        got = np.asarray(losses)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"NCCL {kind} {mode}: losses {losses}, without a group {want.tolist()}")
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        out[f"{kind}_{mode}"] = {"ms": ms, "losses": losses, "max_rel_vs_plain": rel, "param_bytes": resident}
        if rel > NCCL_REL:
            raise AssertionError(f"NCCL {kind} {mode}: losses {losses} differ from {want.tolist()} by {rel:.2e} "
                                 f"(bar {NCCL_REL})")
        # FSDP keeps 1/world of every split leaf at rest: with one rank, all of it
        if mode == "fsdp" and resident * world[1] < runs[(kind, "plain")][2]:
            raise AssertionError(f"NCCL {kind} fsdp: {resident} parameter bytes at rest on one rank, "
                                 f"{runs[(kind, 'plain')][2]} without a group")
    for kind in kinds:
        modes = [m for m in ("plain", "dp", "fsdp") if (kind, m) in runs]
        log(f"{backend} {kind} (one rank, TF32 off): ms/step (first, second) "
            + "; ".join(f"{m} {out[f'{kind}_{m}']['ms'][0]:.1f}, {out[f'{kind}_{m}']['ms'][1]:.1f}" for m in modes)
            + f"; losses vs no group, max rel " + ", ".join(f"{m} {out[f'{kind}_{m}']['max_rel_vs_plain']:.2e}"
                                                         for m in modes[1:])
            + f" (bar {NCCL_REL}); parameter bytes at rest "
            + ", ".join(f"{m} {out[f'{kind}_{m}']['param_bytes']}" for m in modes)
            + f"; phase {'5' if kind == 'gan' else '4'} median (TF32 convs) "
            f"{earlier[kind]:.1f} ms; the gradient all-reduce of {buckets[kind][1] / 2**20:.1f} MiB takes "
            f"{buckets[kind][0]:.3f} ms of device time")
        save = sharded[kind]["save"]
        log(f"{backend} {kind} sharded checkpoint ({'replicated' if kind == 'gan' else 'fsdp'}, one rank): "
            f"restored bitwise; the step resumed from it equals the step resumed from the pickle of the same "
            f"state, bitwise ({sharded[kind]['resumed_losses'][0]}); save ms (pickle, sharded, sharded, pickle) "
            f"{save['ms']['pickle'][0]:.1f}, {save['ms']['orbax'][0]:.1f}, {save['ms']['orbax'][1]:.1f}, "
            f"{save['ms']['pickle'][1]:.1f}; bytes: pickle format {save['bytes']['pickle']['pickle']}, sharded "
            f"format {save['bytes']['orbax']['dir']} in the directory + {save['bytes']['orbax']['pickle']} "
            f"in its pickle")
    return out


def _median_wall_ms(fn, reps=3):
    import numpy as np

    fn()  # first call: allocator, cuDNN plans
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _one_device_shards(synth, texts, n_shards):
    """``synth`` (one device) synthesizing ``texts`` (a power of two of
    them, a multiple of ``n_shards``) in the shards an ``n_shards``-replica
    Synthesizer cuts: the same rows, one frame budget, the same prenet
    seeds."""
    import torch

    from viettts_tpu_torch.infer.pipeline import _shard_seed

    rows = [synth.text_to_token_ids(t) for t in texts]
    toks, lengths, dur_s = synth._durations_for(rows, -1.0)
    n_frames, k = synth._frames(dur_s)[2], len(rows) // n_shards
    with torch.inference_mode():
        return [r for i in range(n_shards) for r in synth._finalize(synth._dispatch(
            rows[i * k:(i + 1) * k], toks[i * k:(i + 1) * k], lengths[i * k:(i + 1) * k], dur_s[i * k:(i + 1) * k],
            0, n_frames, _shard_seed(synth.prenet_seed, i)))]


def replicated_serving(cfg, ckpt_dir: Path, routes=("float32", "bfloat16", "int8"), zero=None, read=None,
                       device="cuda:0"):
    """Phase 6b.  ``Synthesizer(devices=["cuda:0", "cuda:0"])`` (two
    replicas on one card, prenet dropout off) on ``BATCH_TEXTS``, on each
    route (int8 calibrated by ``calibrate_int8`` on each synthesizer):
    bitwise equal to one device decoding the same two shards (same rows,
    frame budget and prenet seeds), and against one device on the whole
    batch float32 mels and waves within ``REPLICA_F32_ATOL``, bf16 and
    int8 waves within ``REPLICA_REL_RMS``.  ``zero()`` / ``read()`` bracket
    the two-replica runs (the launch counters).  Wall ms of
    ``synthesize_batch`` (median of 3, after a first call) on both."""
    import numpy as np
    import torch

    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    def config(route):
        return apply_overrides(cfg.replace(ckpt_dir=ckpt_dir), [
            f"hifigan.inference_dtype={route}", "acoustic.prenet_dropout_at_inference=false"])

    two, results = {}, {}
    if zero is not None:
        zero()
    for route in routes:
        synth = Synthesizer(config(route), devices=[device, device])
        synth.calibrate_int8()
        synth.warmup(batch_sizes=(1,), token_buckets=(32,))  # rounded up to 2 rows, one per replica
        results[route] = synth.synthesize_batch(BATCH_TEXTS)
        for i, res in enumerate(results[route]):
            check_result(res, f"two replicas, {route}, text {i}")
        two[route] = synth
    counts = read() if read is not None else None
    out = {}
    for route in routes:
        one = Synthesizer(config(route), device=device)
        one.calibrate_int8()
        want = one.synthesize_batch(BATCH_TEXTS)
        got = results[route]
        shards = _one_device_shards(one, BATCH_TEXTS, 2)
        for i, (g, w) in enumerate(zip(got, shards)):
            if not (np.array_equal(g.wave, w.wave) and np.array_equal(g.mel, w.mel)):
                raise AssertionError(f"two replicas, {route}, text {i}: not the one device's output on the same "
                                     f"shard (wave max abs {np.abs(g.wave - w.wave).max():.3e})")
        errs = {"mel_max_abs": 0.0, "wave_max_abs": 0.0, "wave_rel_rms": 0.0}
        if route == "int8":  # each synthesizer calibrated on its own first device
            errs["scale_max_abs"] = max(float((s - two[route]._act_scales[i]).abs().max())
                                        for i, s in one._act_scales.items())
        for g, w in zip(got, want):
            if g.wave.shape != w.wave.shape or g.mel.shape != w.mel.shape:
                raise AssertionError(f"two replicas, {route}: shapes {g.wave.shape} vs {w.wave.shape}")
            errs["mel_max_abs"] = max(errs["mel_max_abs"], float(np.abs(g.mel - w.mel).max()))
            errs["wave_max_abs"] = max(errs["wave_max_abs"], float(np.abs(g.wave - w.wave).max()))
            errs["wave_rel_rms"] = max(errs["wave_rel_rms"], rel_rms(torch.from_numpy(g.wave),
                                                                     torch.from_numpy(w.wave)))
        if route == "float32":
            ok = errs["mel_max_abs"] <= REPLICA_F32_ATOL and errs["wave_max_abs"] <= REPLICA_F32_ATOL
        else:
            ok = errs["wave_rel_rms"] <= REPLICA_REL_RMS
        if not ok:
            raise AssertionError(f"two replicas, {route}, differ from one device: {errs}")
        ms_one = _median_wall_ms(lambda: one.synthesize_batch(BATCH_TEXTS))
        ms_two = _median_wall_ms(lambda: two[route].synthesize_batch(BATCH_TEXTS))
        out[route] = {**errs, "ms_one_device": ms_one, "ms_two_replicas": ms_two}
        log(f"two replicas on {device}, {route}: bitwise one device's output on the same shards; vs one "
            f"device on the whole batch mel {errs['mel_max_abs']:.2e}, wave max abs {errs['wave_max_abs']:.2e}, "
            f"rel-RMS {errs['wave_rel_rms']:.2e}; synthesize_batch(4 texts) {ms_one:.1f} ms on one device, "
            f"{ms_two:.1f} ms on two replicas")
    return out, counts


def serve_refuses_missing_cards(ckpt_dir: Path):
    """``serve --num-devices N`` with N one above the visible cards must
    refuse before loading anything."""
    import torch

    from viettts_tpu_torch import serve

    n = torch.cuda.device_count() + 1
    try:
        serve.build_server(["--ckpt-dir", str(ckpt_dir), "--port", "0", "--num-devices", str(n)])
    except ValueError as e:
        log(f"serve --num-devices {n} on {n - 1} card(s): refused ({e})")
        return str(e)
    raise AssertionError(f"serve --num-devices {n} did not refuse on {n - 1} card(s)")


def tools_on_card(cfg, tmp: Path, device="cuda"):
    """Phase 6c.  ``tools.denoise`` over the corpus WAVs on the card and on
    the CPU (samples within 1 LSB), then the duration trainer
    at ``cfg``'s width for 1 step with ``VIETTTS_PROFILE_DIR`` set: it must
    leave a trace holding device kernels."""
    import dataclasses
    import os

    import numpy as np

    from viettts_tpu_torch.audio import read_wav
    from viettts_tpu_torch.tools import denoise
    from viettts_tpu_torch.train import duration
    from viettts_tpu_torch.utils.profiling import PROFILE_ENV

    corpus = tmp / "corpus"
    seconds = {}
    for dev in ("card", "cpu"):
        t0 = time.perf_counter()
        denoise.main(["-i", str(corpus), "-o", str(tmp / f"denoised_{dev}"), "--device",
                      device if dev == "card" else "cpu"])
        seconds[dev] = time.perf_counter() - t0
    files = sorted(corpus.glob("*.wav"))
    worst = 0
    for f in files:
        _, card = read_wav(tmp / "denoised_card" / f.name)
        _, host = read_wav(tmp / "denoised_cpu" / f.name)
        if card.shape != host.shape:
            raise AssertionError(f"denoise {f.name}: {card.shape} on the card, {host.shape} on the CPU")
        worst = max(worst, int(np.abs(card.astype(np.int32) - host.astype(np.int32)).max()))
    if worst > 1:
        raise AssertionError(f"denoise: card and CPU samples differ by {worst} LSB")
    audio_s = sum(len(read_wav(f)[1]) for f in files) / cfg.dsp.sample_rate
    log(f"denoise: {len(files)} WAVs ({audio_s:.1f} s of audio) in {seconds['card']:.2f} s on {device}, "
        f"{seconds['cpu']:.2f} s on the CPU; samples within {worst} LSB")

    trace_dir = tmp / "trace"
    cfg = cfg.replace(data_dir=corpus, ckpt_dir=tmp / "traced")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, num_training_steps=1, val_interval=1, ckpt_interval=1))
    os.environ[PROFILE_ENV] = str(trace_dir)
    try:
        t0 = time.perf_counter()
        duration.train(cfg, device=device)
        traced_s = time.perf_counter() - t0
    finally:
        del os.environ[PROFILE_ENV]
    traces = list(trace_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"the traced trainer left {traces}")
    text = traces[0].read_text()
    kernels = text.count('"cat": "kernel"')
    if kernels == 0 and device == "cuda":
        raise AssertionError("the trace holds no device kernel")
    log(f"trace: duration trainer, 1 step with {PROFILE_ENV} set, in {traced_s:.1f} s: "
        f"{traces[0].name}, {len(text) / 2**20:.1f} MiB, {kernels} device kernel events")
    return {"denoise": {"files": len(files), "audio_s": audio_s, "card_s": seconds["card"],
                        "cpu_s": seconds["cpu"], "max_lsb": worst},
            "trace": {"mib": len(text) / 2**20, "kernel_events": kernels, "s": traced_s}}


def multihost_dryrun(tmp: Path, device="cuda"):
    """Phase 6d.  ``tools.multihost_dryrun`` as one process on ``device``,
    in a subprocess with its own ``file://`` store: one FSDP step of its
    small duration model and its sharded checkpoint's round trip, which
    must be bitwise.  Returns its JSON line."""
    out = tmp / "dryrun"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "viettts_tpu_torch.tools.multihost_dryrun", "--coordinator",
                           f"file://{tmp / 'dryrun_store'}", "--num-processes", "1", "--process-id", "0",
                           "--out-dir", str(out), "--device", device],
                          capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"multihost_dryrun exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {"world_size": 1, "backend": "nccl" if device == "cuda" else "gloo", "restore_bitwise": True, "ok": True}
    if any(result[k] != v for k, v in want.items()) or not result["shard_files"]:
        raise AssertionError(f"multihost_dryrun: {result}")
    log(f"multihost_dryrun on {result['device']}: loss {result['loss']:.6f}, {result['split_leaves']} split leaves, "
        f"restore bitwise, wrote {result['shard_files']} ({result['shard_bytes']} bytes) in "
        f"{result['save_ms']:.1f} ms; "
        f"{seconds:.1f} s with the process start")
    return {**result, "s": seconds}


# ---------------------------------------------------------------------------
# Phase 7: the validation tools on the card
# ---------------------------------------------------------------------------

VALIDATION_GAN_STEPS, VALIDATION_GAN_CLIPS = 30, 48
VALIDATION_E2E_STEPS = (10, 10, 2)  # duration, acoustic, GAN steps at --tiny widths


def validation_tools(tmp: Path, zero, read):
    """Phase 7: ``tools.validate_gan`` (30 steps, B=16, segment 8192, on the
    48-clip corpus), ``tools.validate_int8`` on its checkpoint with
    ``n_eval=2``, ``tools.diagnose_int8`` on it (K3 must stay within the
    simulation's fault bar) and ``tools.validate_e2e_training`` at
    ``--tiny`` widths, each on the card with the launch counters zeroed
    before and read after: K2 for the GAN sample, K2 and K3 for the int8
    tools, K1 and K2 for the e2e synthesis; no plain twin.  Every result
    must be finite and have its tool's keys (a few-step run passes no
    learning criterion, so none is asked)."""
    import numpy as np

    from viettts_tpu_torch.tools import diagnose_int8, validate_e2e_training, validate_gan, validate_int8

    out, launches, times = {}, {}, {}
    root = tmp / "validation"
    gan_dir = root / "gan"
    ckpt, corpus = gan_dir / "ckpt" / "hifigan_latest_ckpt.pickle", gan_dir / "corpus"
    runs = (
        ("validate_gan", ["fused_mrf"],
         lambda: validate_gan.run(VALIDATION_GAN_STEPS, corpus_n=VALIDATION_GAN_CLIPS, out=gan_dir)),
        ("validate_int8", ["fused_mrf", "fused_mrf_int8"],
         lambda: validate_int8.run(ckpt, corpus, n_eval=2, out=root / "int8")),
        ("diagnose_int8", ["fused_mrf", "fused_mrf_int8"],
         lambda: diagnose_int8.run(ckpt, corpus, out=root / "diagnosis")),
        ("validate_e2e_training", ["ar_decode", "fused_mrf"],
         lambda: validate_e2e_training.run(*VALIDATION_E2E_STEPS, tiny=True, out=root / "e2e")),
    )
    for name, kernels, fn in runs:
        zero()
        t0 = time.perf_counter()
        out[name] = fn()
        times[name] = time.perf_counter() - t0
        launches[name] = read(name, kernels)
    gan, int8, diag, e2e = (out[name] for name, _, _ in runs)
    if not (gan["ok_losses_finite"] and gan["steps"] == VALIDATION_GAN_STEPS and ckpt.exists()):
        raise AssertionError(f"validate_gan: {gan}")
    if len(int8["per_clip"]) != 2 or not all(np.isfinite(c[k]) for c in int8["per_clip"] for k in c if k != "clip"):
        raise AssertionError(f"validate_int8: {int8}")
    if diag["kernel_fault"] or not all(np.isfinite(v) for v in diag["rel_rms_vs_f32"].values()):
        raise AssertionError(f"diagnose_int8: K3 against its simulation: {diag}")
    if not (np.isfinite(e2e["acoustic_val_loss_final"]) and np.isfinite(e2e["mel_corr_vs_generator"])
            and e2e["sample_seconds"] > 0):
        raise AssertionError(f"validate_e2e_training: {e2e}")
    log(f"validate_gan: {VALIDATION_GAN_STEPS} steps, {gan['steps_per_sec']:.2f} steps/s "
        f"({gan['steps_per_sec_steady']:.2f} in the back half), mel_l1 {gan['mel_l1_first50_avg']:.3f} -> "
        f"{gan['mel_l1_last_avg']:.3f}, in {times['validate_gan']:.1f} s")
    log(f"validate_int8 (n_eval 2): int8 static rel-RMS {int8['rel_rms_vs_f32_mean']:.3e}, dynamic "
        f"{int8['int8_dynamic_rel_rms_vs_f32_mean']:.3e}, bf16 {int8['bf16_rel_rms_vs_f32_mean']:.3e} against "
        f"float32; MCD {int8['mcd_db_int8_vs_f32_mean']:.3f} / {int8['mcd_db_int8_dynamic_vs_f32_mean']:.3f} / "
        f"{int8['mcd_db_bf16_vs_f32_mean']:.3f} dB, in {times['validate_int8']:.1f} s")
    log(f"diagnose_int8: simulation {diag['rel_rms_vs_f32']['full_static_per_conv']:.3e}, K3 "
        f"{diag['kernel_measured_static']:.3e} (gap {diag['kernel_minus_simulation']:+.2e}), weights only "
        f"{diag['rel_rms_vs_f32']['weights_only']:.3e}, in {times['diagnose_int8']:.1f} s")
    log(f"validate_e2e_training --tiny {VALIDATION_E2E_STEPS}: acoustic val loss {e2e['acoustic_val_loss_init']} -> "
        f"{e2e['acoustic_val_loss_final']}, {e2e['sample_seconds']} s of audio, in "
        f"{times['validate_e2e_training']:.1f} s")
    results = {"validate_gan": {k: v for k, v in gan.items() if k not in ("history", "mcd_history")},
               "validate_int8": {k: v for k, v in int8.items() if k != "per_clip"},
               "diagnose_int8": diag, "validate_e2e_training": e2e}
    return {"results": results, "seconds": times}, launches


# ---------------------------------------------------------------------------
# Phase 8: F6 on the card, the benchmark programs
# ---------------------------------------------------------------------------

SNAP_TOKEN_BUCKET = 64  # SENTENCE's token bucket (41 tokens)
SNAP_CASES = ((300, 512), (600, 640))  # (pinned frames, frames decoded after warmup's 256 and 512)
BENCH_VOCODER_BATCHES = (1, 8, 64)  # of scripts/tune_vocoder_batch.py's five


def snap_check(cfg, ckpt_dir: Path, device="cuda"):
    """Phase 8a (F6): a bucketed dispatch snaps up to a frame bucket that
    ``warmup`` ran, at most twice its natural one, as JAX's
    ``_dispatch_decode`` does (``SNAP_CASES``); the frame count of each
    decode is read off the acoustic model's call, the audio checked."""
    import torch

    from viettts_tpu_torch.config import WORD_END_INDEX
    from viettts_tpu_torch.infer.pipeline import Synthesizer, _bucket_frames

    synth = Synthesizer(cfg.replace(ckpt_dir=ckpt_dir), device=device)
    synth.warmup(token_buckets=(SNAP_TOKEN_BUCKET,))
    key = (1, SNAP_TOKEN_BUCKET)
    warmed = sorted(synth._seen_nf.get(key, ()))
    if warmed != [256, 512]:
        raise AssertionError(f"F6: warmup ran frame buckets {warmed} at {key}, want JAX's [256, 512]")
    synth.single_dispatch_max_tokens = 0
    seen, decode = [], synth.acoustic_model.inference

    def spy(toks, durs, n_frames, *args, **kwargs):
        seen.append(n_frames)
        return decode(toks, durs, n_frames, *args, **kwargs)

    synth.acoustic_model.inference = spy
    row = synth.text_to_token_ids(SENTENCE)
    counted = sum(t != WORD_END_INDEX for t in row)  # word ends are zeroed
    fps = cfg.dsp.sample_rate / cfg.dsp.hop_length
    out = {"warmed": warmed}
    for frames, want in SNAP_CASES:
        synth.duration_model = lambda batch, s=frames / counted / fps, **_: torch.full(
            batch.phonemes.shape, s, device=batch.phonemes.device)
        seen.clear()
        res = synth.synthesize(SENTENCE)
        check_result(res, f"F6 snap ({frames} frames)")
        natural = _bucket_frames(frames + 1)
        out[f"{frames}_frames"] = {"natural": natural, "decoded": list(seen), "kept": int(res.mel.shape[0])}
        if seen != [want]:
            raise AssertionError(f"F6: {frames} frames (natural bucket {natural}) decoded {seen}, want [{want}]")
    if sorted(synth._seen_nf[key]) != [256, 512, 640]:
        raise AssertionError(f"F6: frame buckets at {key} after the requests: {sorted(synth._seen_nf[key])}")
    log(f"F6 on the card: warmed {warmed} at (B, T) {key}; " + "; ".join(
        f"{f} frames (natural {out[f'{f}_frames']['natural']}) decoded {out[f'{f}_frames']['decoded']}"
        for f, _ in SNAP_CASES))
    return out


@contextlib.contextmanager
def _torch_defaults():
    """PyTorch's own TF32 defaults (cuDNN convs in TF32, matmuls in
    float32), under which ``python -m`` runs the benchmark programs; the
    flags before are restored."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def bench_phase(zero, read):
    """Phase 8b: each benchmark program's ``run()`` at its shapes with
    fewer iterations, its JSON line printed; the launch counters zeroed
    before and read after each (the programs themselves refuse a twin or
    a missing kernel on the card).  Returns the results, seconds and
    launches by program."""
    from viettts_tpu_torch.bench import b1_vocoder, batch, e2e, stream, train, vocoder_batch

    programs = (
        ("e2e", lambda: e2e.run(iters=3, warmup=1), ["ar_decode", "fused_mrf", "mrf_conv_wgmma"]),
        ("batch", lambda: batch.run(iters=2, warmup=1), ["ar_decode", "fused_mrf", "mrf_conv_wgmma"]),
        ("train", lambda: train.run(iters=1, warmup=1, gan_steps=2), []),
        ("vocoder_batch", lambda: vocoder_batch.run(iters=2, warmup=1, batches=BENCH_VOCODER_BATCHES),
         ["fused_mrf", "mrf_conv_wgmma", "mrf_conv_wgmma_tf32"]),
        ("b1_vocoder", lambda: b1_vocoder.run(iters=4, warmup=1),
         ["fused_mrf", "fused_mrf_int8", "mrf_conv_wgmma", "mrf_conv_wgmma_int8", "mrf_conv_wgmma_tf32",
          "mrf_conv_wgmma_int8_dynamic"]),
        ("stream", lambda: stream.run(iters=2, warmup=1), ["ar_decode", "fused_mrf", "mrf_conv_wgmma"]),
    )
    results, seconds, launches = {}, {}, {}
    with _torch_defaults():
        for name, fn, kernels in programs:
            zero()
            t0 = time.perf_counter()
            results[name] = fn()
            seconds[name] = time.perf_counter() - t0
            launches[name] = read(f"bench {name}", kernels)
            print(json.dumps(results[name]), flush=True)
    e, b, t, v, b1, st = (results[n] for n, _, _ in programs)
    log(f"bench e2e: RTF {e['value']:.5f} (vs 0.01 target {e['vs_baseline']:.3f}), stages "
        + ", ".join(f"{k} {ms:.2f} ms" for k, ms in e["stage_ms"].items())
        + f"; batch B=64: {b['full_pipeline_audio_secs_per_sec']:.1f} s-audio/s, full {b['full_pipeline_ms']:.1f} ms,"
        f" vocoder {b['vocoder_ms']:.1f} ms; train: acoustic {t['optimizer_steps_per_sec']:.3f} steps/s, GAN "
        f"{t['vocoder_gan']['steps_per_sec_f32']:.3f} (f32) / {t['vocoder_gan']['steps_per_sec_bf16']:.3f} (bf16) "
        f"steps/s; vocoder " + ", ".join(f"B={r['batch']} {r['route']} {r['ms']:.2f} ms" for r in v["rows"])
        + "; B=1 " + ", ".join(f"{k} {r['ms']:.2f} ms" for k, r in b1["routes"].items())
        + f"; stream: first audio {1e3 * st['stream_first_chunk_s']:.1f} ms (lead 0: "
        f"{1e3 * st['stream_first_chunk_full_lead_s']:.1f} ms), one shot {1e3 * st['one_shot_latency_s']:.1f} ms, "
        f"{st['text_tokens']} tokens"
        + "; seconds " + ", ".join(f"{k} {s:.1f}" for k, s in seconds.items()))
    return {"results": results, "seconds": seconds}, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.ops import _build
    from viettts_tpu_torch.ops.ar_decoder import ar_decode
    from viettts_tpu_torch.ops.mrf import fused_mrf
    from viettts_tpu_torch.utils.flops import device_peaks, mrf_bound, mrf_flop, stage_shapes

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
    k1_plan_err, k1_plan_times = check_ar_decode_plan(dev)
    t0 = time.perf_counter()
    k1_wide = {H: check_ar_decode(dev, H=H, cases=cases) for H, cases in K1_WIDE.items()}
    k1_wide_plan = check_ar_decode_plan(dev, H=WIDE_DECODERS[0])
    log(f"K1 at the wide decoder widths: {time.perf_counter() - t0:.1f} s")
    k2_err, k2_times = check_fused_mrf(dev, cfg.hifigan)
    k3, k3_times = check_fused_mrf_int8(dev, cfg.hifigan)
    t0 = time.perf_counter()
    bulk = check_bulk(dev, cfg.hifigan)
    log(f"bulk shape phase: {time.perf_counter() - t0:.1f} s")

    def zero_counts():
        ar_decode.launches = ar_decode.plain_calls = 0
        fused_mrf.launches = fused_mrf.int8_launches = fused_mrf.plain_calls = 0
        fused_mrf.conv_launches = fused_mrf.int8_conv_launches = 0
        fused_mrf.tf32_conv_launches = fused_mrf.int8_dynamic_conv_launches = 0

    def read_counts(path, kernels):
        counts = {"ar_decode": (ar_decode.launches, ar_decode.plain_calls),
                  "fused_mrf": (fused_mrf.launches, fused_mrf.plain_calls),
                  "fused_mrf_int8": (fused_mrf.int8_launches, fused_mrf.plain_calls),
                  "mrf_conv_wgmma": (fused_mrf.conv_launches, fused_mrf.plain_calls),
                  "mrf_conv_wgmma_int8": (fused_mrf.int8_conv_launches, fused_mrf.plain_calls),
                  "mrf_conv_wgmma_tf32": (fused_mrf.tf32_conv_launches, fused_mrf.plain_calls),
                  "mrf_conv_wgmma_int8_dynamic": (fused_mrf.int8_dynamic_conv_launches, fused_mrf.plain_calls)}
        log(f"{path} launches (kernel, plain twin): {counts}")
        for name in kernels:
            launches, plain = counts[name]
            if launches == 0 or plain != 0:
                raise AssertionError(f"{path}: {name} had {launches} kernel launches, {plain} plain calls")
        return {name: counts[name][0] for name in counts}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        write_checkpoints(cfg, tmp)
        zero_counts()
        stats = main_path(cfg, tmp, tmp)
        launches = read_counts("main path (bf16, f32)", ["ar_decode", "fused_mrf", "mrf_conv_wgmma",
                                                          "mrf_conv_wgmma_tf32"])
        zero_counts()
        stats["int8"], int8_synth = int8_path(cfg, tmp, tmp)
        launches_int8 = read_counts("main path (int8)", ["ar_decode", "fused_mrf", "fused_mrf_int8",
                                                         "mrf_conv_wgmma_int8", "mrf_conv_wgmma_int8_dynamic"])
        ref = reference_check(cfg, tmp)
        ref["int8"] = reference_check_int8(cfg, tmp, int8_synth)
        t0 = time.perf_counter()
        stats["lead"] = lead_phase(cfg, tmp, zero_counts, read_counts)
        stats["lead"]["seconds"] = time.perf_counter() - t0
        log(f"lead phase: {stats['lead']['seconds']:.1f} s")
        launches_lead = {route: stats["lead"][route]["launches"] for route in ("bfloat16", "float32", "int8")}
        stats["wide_decoder"] = {H: wide_decoder_phase(cfg, tmp, zero_counts, read_counts, H) for H in WIDE_DECODERS}
        train, trained = train_phase(cfg, tmp)
        train["gan"], vocoder = gan_phase(cfg, tmp / "corpus", trained, tmp)
        zero_counts()
        train["round_trip"] = round_trip(cfg, trained, vocoder, GAN_STEPS + GTA_STEPS)
        launches_trained = read_counts("train round trip", ["ar_decode", "fused_mrf", "fused_mrf_int8",
                                                            "mrf_conv_wgmma", "mrf_conv_wgmma_int8",
                                                            "mrf_conv_wgmma_tf32"])
        train["card_vs_cpu"] = train_card_vs_cpu()
        train["gan_card_vs_cpu"] = gan_card_vs_cpu()

        earlier = {"duration": train["duration"]["median_ms"], "acoustic": train["acoustic"]["median_ms"],
                   "gan": train["gan"]["audio"]["median_ms"]}
        multi = {"nccl_training": nccl_training(cfg, tmp, earlier)}
        multi["replicas"], launches_replicated = replicated_serving(
            cfg, tmp, zero=zero_counts,
            read=lambda: read_counts("two replicas on cuda:0", ["ar_decode", "fused_mrf", "fused_mrf_int8"]))
        multi["serve_refusal"] = serve_refuses_missing_cards(tmp)
        multi["tools"] = tools_on_card(cfg, tmp)
        multi["dryrun"] = multihost_dryrun(tmp)
        validation, launches_validation = validation_tools(tmp, zero_counts, read_counts)
        t0 = time.perf_counter()
        snap = snap_check(cfg, tmp)
        bench, launches_bench = bench_phase(zero_counts, read_counts)
        bench["phase_seconds"] = time.perf_counter() - t0
        log(f"phase 8 (F6 and the benchmark programs): {bench['phase_seconds']:.1f} s")

    bf16, f32 = torch.bfloat16, torch.float32

    def stage_sum(times, col, case=(2, 128)):
        return sum(r[col] for r in times[case])

    k1_main = k1_times[(1, 512)]
    b1 = (1, MAIN_PATH_FRAMES)
    peaks = device_peaks()
    k2_bound, k2_by = mrf_bound(cfg.hifigan, 2, 128, "bfloat16", peaks)
    k2_bound_f32, k2_by_f32 = mrf_bound(cfg.hifigan, 2, 128, "float32", peaks)
    k3_bound, k3_by = mrf_bound(cfg.hifigan, 2, 128, "int8", peaks)
    k3_bound_b1, _ = mrf_bound(cfg.hifigan, 1, MAIN_PATH_FRAMES, "int8", peaks)

    def k3_sum(key, case=(2, 128)):
        return sum(r[key] for r in k3_times[case])

    def mrf_flop_sum(B, T):  # the MRF convs of the four ResBlock1 stages
        return sum(mrf_flop(cfg.hifigan, B, L_in * u, C, False) for _, C, _, u, L_in, _ in stage_shapes(cfg.hifigan, T))
    kernels = [
        {"name": "ar_decode", "route": "cuda", "source": "viettts_tpu_torch/csrc/ar_decoder.cuh",
         "replaces": "viettts_tpu/ops/ar_decoder.py:140", "launches": launches["ar_decode"],
         "launches_int8_path": launches_int8["ar_decode"], "launches_round_trip": launches_trained["ar_decode"],
         "launches_replicated": launches_replicated["ar_decode"],
         "launches_validation": {tool: n["ar_decode"] for tool, n in launches_validation.items()},
         "launches_lead": {route: n["ar_decode"] for route, n in launches_lead.items()},
         "launches_bench": {name: n["ar_decode"] for name, n in launches_bench.items()},
         "max_abs_err": max(k1_err, k1_plan_err), "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"], "library_ms": None,
         "library": "none: no single PyTorch call runs the fed-back decode",
         "cases": {f"B={B} L={L}": v for (B, L), v in k1_times.items()},
         f"cases_{SMALL_CARD_SMS}_sm_plan": {f"B={B} L={L}": v for (B, L), v in k1_plan_times.items()},
         "shape": "B=1 L=512 H=512 P=256 D=80 f32"},
        *[{"name": f"ar_decode_H{H}", "route": "cuda", "source": "viettts_tpu_torch/csrc/ar_decoder.cuh",
           "replaces": "viettts_tpu/ops/ar_decoder.py:140",
           "launches": stats["wide_decoder"][H]["launches"]["ar_decode"],
           "launches_note": f"phase 3d: a decoder_dim={H} Synthesizer's lead replay, synthesize_batch and stream",
           "max_abs_err": max([err] + ([k1_wide_plan[0]] if H == WIDE_DECODERS[0] else [])),
           "ms": times[(1, 512)]["ms"], "plain_ms": times[(1, 512)]["plain_ms"],
           "bound_ms": times[(1, 512)]["bound_ms"], "bound_by": times[(1, 512)]["bound_by"], "library_ms": None,
           "library": "none: no single PyTorch call runs the fed-back decode",
           "plan": times[(1, 512)]["plan"], "cases": {f"B={B} L={L}": v for (B, L), v in times.items()},
           **({f"cases_{SMALL_CARD_SMS}_sm_plan": {f"B={B} L={L}": v for (B, L), v in k1_wide_plan[1].items()},
               "max_abs_err_H2048": k1_wide[2048][0],
               "cases_H2048": {f"B={B} L={L}": v for (B, L), v in k1_wide[2048][1].items()}}
              if H == WIDE_DECODERS[0] else {}),
           "phase_3d": {k: v for k, v in stats["wide_decoder"][H].items() if k != "launches"},
           "shape": f"B=1 L=512 H={H} P=256 D=80 f32"}
          for H in WIDE_DECODERS for err, times in [k1_wide[H]]],
        {"name": "fused_mrf", "route": "cuda", "source": "viettts_tpu_torch/csrc/mrf.cu",
         "replaces": "viettts_tpu/ops/mrf.py:440", "launches": launches["fused_mrf"],
         "launches_int8_path": launches_int8["fused_mrf"], "launches_round_trip": launches_trained["fused_mrf"],
         "launches_replicated": launches_replicated["fused_mrf"],
         "launches_validation": {tool: n["fused_mrf"] for tool, n in launches_validation.items()},
         "launches_lead": {route: n["fused_mrf"] for route, n in launches_lead.items()},
         "launches_bench": {name: n["fused_mrf"] for name, n in launches_bench.items()},
         "max_abs_err": k2_err[f32], "max_abs_err_bf16": k2_err[bf16],
         "max_rel_rms_vs_bf16_dots_twin": k2_err["bf16_dots_rel_rms"],
         "ms": stage_sum(k2_times[bf16], 0), "plain_ms": stage_sum(k2_times[bf16], 1),
         "ms_f32": stage_sum(k2_times[f32], 0), "plain_ms_f32": stage_sum(k2_times[f32], 1),
         "bound_ms": k2_bound, "bound_by": k2_by, "bound_ms_f32": k2_bound_f32, "bound_by_f32": k2_by_f32,
         "mrf_ms": stage_sum(k2_times[bf16], 2), "mrf_ms_f32": stage_sum(k2_times[f32], 2),
         "library_ms": stage_sum(k2_times[bf16], 4), "library_ms_f32": stage_sum(k2_times[f32], 4),
         "library": "the 18 MRF convs of each stage as torch conv1d calls (cuDNN), summed over the 4 stages: "
                    "compare with mrf_ms (bf16; _f32: float32, TF32 off)",
         "mrf_ms_b1": stage_sum(k2_times[bf16], 2, b1), "library_ms_b1": stage_sum(k2_times[bf16], 4, b1),
         "bulk": {k: bulk[k] for k in ("bfloat16", "float32")},
         "stages": {f"{str(dt)[6:]} B={B} T={T}": {
             "ms": [r[0] for r in rows], "plain_ms": [r[1] for r in rows],
             "mrf_ms": [r[2] for r in rows], "mrf_tflops": [r[3] for r in rows], "library_ms": [r[4] for r in rows]}
             for dt in (bf16, f32) for (B, T), rows in k2_times[dt].items()},
         "shape": "4 default stages summed, B=2, 128 mel frames, ResBlock1; ms in bf16; bulk: the MRF convs "
                  f"alone at B={BULK[0]}, {BULK[1]} frames"},
        {"name": "fused_mrf_int8", "route": "cuda", "source": "viettts_tpu_torch/csrc/mrf_int8.cu",
         "replaces": "viettts_tpu/ops/mrf.py:440 (quantize_int8)", "launches": launches_int8["fused_mrf_int8"],
         "launches_round_trip": launches_trained["fused_mrf_int8"],
         "launches_replicated": launches_replicated["fused_mrf_int8"],
         "launches_validation": {tool: n["fused_mrf_int8"] for tool, n in launches_validation.items()},
         "launches_lead": launches_lead["int8"]["fused_mrf_int8"],
         "launches_bench": {name: n["fused_mrf_int8"] for name, n in launches_bench.items()},
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
         "library": "none: no PyTorch call runs int8 convolutions (bulk: cuDNN bf16 as a yardstick)",
         "bulk": {"static": bulk["int8"], "dynamic": bulk["int8_dynamic"],
                  "cudnn_bf16_ms": bulk["bfloat16"]["library_ms"]},
         "stages": {f"B={B} T={T}": {key: [r[key] for r in rows] for key in rows[0]}
                    for (B, T), rows in k3_times.items()},
         "shape": "4 default stages summed, B=2, 128 mel frames (_b1: B=1, "
                  f"{MAIN_PATH_FRAMES} frames), ResBlock1, bf16 storage; ms static scales"},
    ]
    def wgmma_entry(name, counter, route, main, source_note):
        """The per-conv wgmma pipeline on one route: the MRF convs of the
        stages it takes at the bulk shape (``check_bulk``), beside the
        twin, mma_conv_kernel, the library call (cuDNN bf16, or float32
        with TF32 off; int8 has none: cuDNN bf16 as a yardstick) and the
        bound; launches from the paths that ran it."""
        w = bulk[route]["wgmma"]
        widths = " and ".join(f"C = {C}" for C in w)
        library = {"bfloat16": "the stages' 18 MRF convs each as torch conv1d calls (cuDNN), bf16",
                   "float32": "the stages' 18 MRF convs each as torch conv1d calls (cuDNN), float32, TF32 off"}
        return {
            "name": name, "route": "cuda", "source": "viettts_tpu_torch/csrc/mrf_conv_wgmma.cuh",
            "replaces": f"viettts_tpu/ops/mrf.py:440 ({source_note})", "launches": main[counter],
            "launches_lead": {r: n[counter] for r, n in launches_lead.items()},
            "launches_round_trip": launches_trained[counter],
            "launches_bench": {n: c[counter] for n, c in launches_bench.items()},
            "max_abs_err": max(v["max_abs_err"] for v in w.values()),
            "max_rel_rms": max(v["rel_rms"] for v in w.values()),
            "ms": sum(v["ms"] for v in w.values()), "plain_ms": sum(v["plain_ms"] for v in w.values()),
            "per_conv_ms": sum(v["per_conv_ms"] for v in w.values()),
            "bound_ms": sum(v["bound_ms"] for v in w.values()), "bound_by": w[max(w)]["bound_by"],
            "library_ms": sum(v["library_ms"] for v in w.values()) if route in library else None,
            "cudnn_bf16_ms": sum(v["cudnn_bf16_ms"] for v in w.values()),
            "library": library.get(route, "none: no PyTorch call runs int8 convolutions "
                                          "(cudnn_bf16_ms: cuDNN bf16 as a yardstick)"),
            "issued_tflops": sum(v["issued_flop"] for v in w.values()) / sum(v["ms"] for v in w.values()) / 1e9,
            "stages": {str(C): v for C, v in w.items()},
            "shape": f"the MRF convs of the {widths} stages summed, B={BULK[0]}, {BULK[1]} mel frames; "
                     "per_conv_ms: the same on mma_conv_kernel; plain_ms: the twin, one run"}

    kernels += [
        wgmma_entry("mrf_conv_wgmma", "mrf_conv_wgmma", "bfloat16", launches,
                    "the MRF convs of the C = 256 and 128 stages, bf16"),
        wgmma_entry("mrf_conv_wgmma_int8", "mrf_conv_wgmma_int8", "int8", launches_int8,
                    "quantize_int8 with static scales: the MRF convs of the C = 256 and 128 stages"),
        wgmma_entry("mrf_conv_wgmma_tf32", "mrf_conv_wgmma_tf32", "float32", launches,
                    "the float32 route's MRF convs, 3xTF32"),
        wgmma_entry("mrf_conv_wgmma_int8_dynamic", "mrf_conv_wgmma_int8_dynamic", "int8_dynamic", launches_int8,
                    "quantize_int8 with dynamic scales: the MRF convs"),
    ]
    log(json.dumps({"card": smi, "main_path": stats, "reference_errors": ref, "train": train,
                    "multi_device": multi, "validation": validation, "snap": snap,
                    "bench_seconds": bench["seconds"], "phase8_seconds": bench["phase_seconds"]}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
