#!/usr/bin/env python3
"""Time of the int8 route's refused stage (``models.hifigan.xla_stage``,
JAX's XLA stage in bf16) on one CUDA GPU, with its conv sums in each of
three forms, and what each gives on the card against the CPU.

    python3 scripts/time_xla_stage.py [--frames 127,1001] [--reps 5]

Stage 0 of ``HifiGanConfig()`` at B=1 (the TPU kernel refuses it at odd
frame counts, so JAX runs it as XLA convs), default torch init, seed 0.
The forms of ``_xla_conv``'s sums: ``float64_gemm`` (the package's: one
float64 matrix product over the taps' shifted copies), ``float64_cudnn``
(a float64 cuDNN conv1d) and ``float32_cudnn`` (a float32 cuDNN conv1d,
TF32 off).  For each frame count: one C = 256, k = 11, dilation 5 conv
alone; the stage (CUDA events, the mean of ``--reps`` calls after one
warm-up) beside bf16 K2's fused stage on the same input; at the first
count the card's stage output against the CPU's (``float64_gemm`` on the
CPU), bit for bit or its rel-RMS; and the whole generator on the int8
route (dynamic scales, stage 0 on the form) beside its bf16 route.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    import torch
    from torch.nn import functional as F

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", default="127,1001")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_xla_stage: no CUDA device", file=sys.stderr)
        return 1
    sys.path.append(str(REPO))  # chip_smoke.py, after any checkout on PYTHONPATH
    import chip_smoke
    from viettts_tpu_torch.config import HifiGanConfig
    from viettts_tpu_torch.models import hifigan
    from viettts_tpu_torch.ops.mrf import fused_mrf

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def cudnn(dtype):
        def conv(x, w, b, d, store):
            k = w.shape[0]
            y = F.conv1d(x.to(dtype), w.to(store).permute(2, 1, 0).to(dtype), padding=d * (k - 1) // 2, dilation=d)
            return y.float().to(store) + b.to(store)[None, :, None]

        return conv

    forms = {"float64_gemm": hifigan._xla_conv, "float64_cudnn": cudnn(torch.float64),
             "float32_cudnn": cudnn(torch.float32)}
    cfg, bf16, dev = HifiGanConfig(), torch.bfloat16, torch.device("cuda")
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    torch.manual_seed(0)
    cpu = hifigan.Generator(cfg).eval()
    gen = hifigan.Generator(cfg).eval()
    gen.load_state_dict(cpu.state_dict())
    gen = gen.to(dev)
    g = torch.Generator().manual_seed(1)
    result = {"card": smi, "forms": list(forms)}
    with torch.no_grad():
        h = torch.randn(1, 256, 8008, generator=g).to(dev, bf16)
        w = (torch.randn(11, 256, 256, generator=g) * 0.02).to(dev, bf16)
        b = torch.zeros(256, device=dev)
        result["one_conv_ms"] = {name: chip_smoke.time_ms(lambda: conv(h, w, b, 5, bf16), reps=2 * args.reps)
                                 for name, conv in forms.items()}
        print(f"one conv (C = 256, k = 11, dilation 5, 8,008 rows): {result['one_conv_ms']}", flush=True)
        frames = [int(f) for f in args.frames.split(",")]
        for T in frames:
            x = (torch.randn(1, T, 512, generator=g) * 0.5).to(bf16)
            xg = x.to(dev)
            wq, ups, pst = gen.fused_weights(bf16)[0]
            row = {"k2_bf16_ms": chip_smoke.time_ms(
                lambda: fused_mrf(xg, wq, ks, ds, upsample=ups, post=pst, compute_dtype=bf16), reps=2 * args.reps)}
            mel = torch.randn(1, T, 80, generator=g).to(dev)
            row["vocode_bf16_ms"] = chip_smoke.time_ms(lambda: hifigan.generator_apply_fused(gen, mel, bf16),
                                                       reps=args.reps)
            want = hifigan.xla_stage(x, *cpu.fused_weights(bf16)[0], ks, ds, bf16).float() if T == frames[0] else None
            for name, conv in forms.items():
                hifigan._xla_conv = conv
                try:
                    row[f"{name}_ms"] = chip_smoke.time_ms(
                        lambda: hifigan.xla_stage(xg, wq, ups, pst, ks, ds, bf16), reps=args.reps)
                    row[f"{name}_vocode_int8_ms"] = chip_smoke.time_ms(
                        lambda: hifigan.generator_apply_fused(gen, mel, bf16, quantize_int8=True), reps=args.reps)
                    if want is not None:
                        got = hifigan.xla_stage(xg, wq, ups, pst, ks, ds, bf16).float().cpu()
                        row[f"{name}_bitwise_cpu"] = torch.equal(got, want)
                        row[f"{name}_rel_rms_cpu"] = chip_smoke.rel_rms(got, want)
                finally:
                    hifigan._xla_conv = forms["float64_gemm"]
            result[f"T={T}"] = row
            print(f"stage 0, B=1, {T} frames: {row}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
