#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

1. Environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the nvcc build of the port's kernels from
   ``viettts_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch twin on the card, at the shapes
   the main path gives it, TF32 off: K1 ``ar_decode`` (H=512, P=256, D=80;
   B in {1, 4}; 512 and 300 frames; dropout masks on) and K2 ``fused_mrf``
   (the four default generator stages, B=2, 128 and 100 mel frames,
   ConvTranspose prologue on, conv_post epilogue on the last stage,
   ResBlock1 and ResBlock2, float32 and bfloat16 storage), with both times.
3. The main path at the full default width (``Config()``) on seeded random
   weights written as native checkpoints: the port's CLI on one sentence,
   then ``Synthesizer.synthesize_batch`` on 4 texts, on the default bf16
   vocoder route and on the ``--quality`` float32 route.  Launch counters
   are zeroed just before and read just after: every kernel must have
   launched and no plain twin may have run.  The outputs must be finite,
   in [-1, 1] and 256 samples per mel frame, and a float32 synthesis on the
   card must agree with the same synthesis on the CPU (plain twins).
4. A JSON line of per-kernel results, then the last line
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
BATCH_TEXTS = [
    "một hai ba",
    "hôm qua em tới trường, mẹ dắt tay từng bước",
    "số điện thoại là không chín tám bảy sáu năm bốn ba hai một",
    "tuyệt vời quá!",
]
K1_ATOL = 1e-4
K2_F32 = dict(rtol=1e-5, atol=1e-4)
K2_BF16_REL = 0.02  # of max(|reference|, 1), the bar of tests/test_mrf.py


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
    import numpy as np

    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------


def check_ar_decode(dev, H=512, P=256, D=80, cases=((1, 512), (4, 512), (1, 300), (4, 300))):
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
        want = ar_decode_plain(*args)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        log(f"K1 ar_decode B={B} L={L}: max|kernel - twin| = {err:.3e} (atol {K1_ATOL})")
        if not err <= K1_ATOL:
            raise AssertionError(f"ar_decode B={B} L={L} differs from its twin by {err}")
        if L == 512:
            times[B] = (time_ms(lambda: ar_decode(*args)), time_ms(lambda: ar_decode_plain(*args), reps=2))
            log(f"K1 ar_decode B={B} L={L}: kernel {times[B][0]:.3f} ms, twin {times[B][1]:.3f} ms")
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


def check_fused_mrf(dev, cfg, B=2, frames=(128, 100)):
    import numpy as np
    import torch

    from viettts_tpu_torch.ops.mrf import fused_mrf, fused_mrf_plain

    rng = np.random.default_rng(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    times = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    for dtype in (torch.float32, torch.bfloat16):
        for resblock2 in (False, True):
            for T in frames:
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
                        ok = err <= K2_BF16_REL * scale
                        bar = f"atol {K2_BF16_REL * scale:.3g}"
                    tag = (f"K2 fused_mrf {str(dtype)[6:]} resblock{'2' if resblock2 else '1'} "
                           f"stage {i} x=[{B},{L_in},{C_in}] -> [{B},{L_in * u},{1 if post else C}]")
                    log(f"{tag}: max|kernel - twin| = {err:.3e} ({bar})")
                    if not ok:
                        raise AssertionError(f"{tag} differs from its twin by {err}")
                    if T == frames[0] and not resblock2:
                        ms = time_ms(lambda: fused_mrf(x, w, ks, ds, **kw))
                        plain_ms = time_ms(lambda: fused_mrf_plain(x, w, ks, ds, **kw))
                        times[dtype][0] += ms
                        times[dtype][1] += plain_ms
                        log(f"{tag}: kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
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

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        write_checkpoints(cfg, tmp)
        for fn in (ar_decode, fused_mrf):
            fn.launches = fn.plain_calls = 0
        stats = main_path(cfg, tmp, tmp)
        counts = {fn.__name__: (fn.launches, fn.plain_calls) for fn in (ar_decode, fused_mrf)}
        log(f"main path launches (kernel, plain twin): {counts}")
        for name, (launches, plain) in counts.items():
            if launches == 0 or plain != 0:
                raise AssertionError(f"{name}: {launches} kernel launches, {plain} plain calls")
        ref = reference_check(cfg, tmp)

    bf16, f32 = torch.bfloat16, torch.float32
    kernels = [
        {"name": "ar_decode", "route": "cuda", "source": "viettts_tpu_torch/csrc/ar_decoder.cu",
         "replaces": "viettts_tpu/ops/ar_decoder.py:140", "launches": counts["ar_decode"][0],
         "max_abs_err": k1_err, "ms": k1_times[1][0], "plain_ms": k1_times[1][1],
         "shape": "B=1 L=512 H=512 P=256 D=80 f32"},
        {"name": "fused_mrf", "route": "cuda", "source": "viettts_tpu_torch/csrc/mrf.cu",
         "replaces": "viettts_tpu/ops/mrf.py:440", "launches": counts["fused_mrf"][0],
         "max_abs_err": k2_err[f32], "max_abs_err_bf16": k2_err[bf16],
         "ms": k2_times[bf16][0], "plain_ms": k2_times[bf16][1],
         "ms_f32": k2_times[f32][0], "plain_ms_f32": k2_times[f32][1],
         "shape": "4 default stages summed, B=2, 128 mel frames, ResBlock1; ms in bf16"},
    ]
    log(json.dumps({"card": smi, "main_path": stats, "reference_errors": ref}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
