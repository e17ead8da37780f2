#!/usr/bin/env python3
"""Where a synthesis spends its time on the card: ``torch.profiler`` over
``Synthesizer.synthesize`` (B=1) and ``synthesize_batch`` (B=4) of the
PyTorch port, after warm-up, at the full default width on seeded random
weights, on the bf16, float32 and int8 vocoder routes.

    python3 scripts/profile_torch_synthesis.py [--out DIR]

Prints, per route and batch: wall time with the profiler on, summed device
time (kernels and copies), the device-busy share of the wall time, and the
device time of the port's kernels (K1, K2, K3, by kernel name) beside
the rest; then the ten largest device-time entries.  With
``--out`` it also writes one Chrome trace per run.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the same sentence and batch as chip_smoke.py's main path
from chip_smoke import BATCH_TEXTS, SENTENCE, write_checkpoints  # noqa: E402

# kernel names in viettts_tpu_torch/csrc: mma_conv_kernel by its traits; mrf_fused_kernel,
# mrf_conv_wgmma_kernel and conv_operand_kernel by their route, (viettts::FRoute)0 bf16, 1 int8
# (static and dynamic scales, whose quantize passes are conv_operand_kernel's) or 2 tf32 (float32)
PORT_KERNELS = {
    "bi-LSTM": ("bilstm_grid",),
    "K1": ("ar_decode_grid",),
    "K2": ("Bf16Mma", "Tf32Mma", "post_kernel", "to_f32_kernel", "FRoute)0", "FRoute)2"),
    "K3": ("Int8Mma", "F64Mma", "absmax_kernel", "FRoute)1"),
}


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0))


def profile_once(fn, trace: Path | None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    # device-side entries only (kernels, copies, memsets): a CPU-side op's
    # self device time repeats its kernels'
    rows = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    groups = {name: sum(ms for key, ms, _ in rows if any(k in key for k in keys))
              for name, keys in PORT_KERNELS.items()}
    groups["other"] = total - sum(groups.values())
    return {"wall_ms": wall_ms, "device_ms": total, "busy_share": total / wall_ms,
            "device_entries": sum(n for _, _, n in rows), "groups_ms": groups, "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:10]]}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=None, help="directory for Chrome traces")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_synthesis: no CUDA device", file=sys.stderr)
        return 1
    from viettts_tpu_torch.config import Config, apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    results = {}
    cfg = Config()
    with tempfile.TemporaryDirectory(prefix="profile_") as tmp:
        write_checkpoints(cfg, Path(tmp))
        for route in ("bfloat16", "float32", "int8"):
            synth = Synthesizer(apply_overrides(cfg.replace(ckpt_dir=Path(tmp)), [f"hifigan.inference_dtype={route}"]),
                                device="cuda")
            synth.warmup(batch_sizes=(1, 4), token_buckets=(32, 64))
            for name, fn in (("B=1", lambda: synth.synthesize(SENTENCE)),
                             ("B=4", lambda: synth.synthesize_batch(BATCH_TEXTS))):
                fn()
                trace = None if args.out is None else args.out / f"trace_{route}_{name[-1]}.json"
                res = profile_once(fn, trace)
                results[f"{route} {name}"] = res
                groups = ", ".join(f"{k} {v:.2f} ms" for k, v in res["groups_ms"].items())
                print(f"{route} {name}: wall {res['wall_ms']:.1f} ms (profiler on), device {res['device_ms']:.1f} ms "
                      f"({100 * res['busy_share']:.0f}% busy); {groups}", flush=True)
                for row in res["top"]:
                    print(f"    {row['ms']:8.3f} ms  {row['calls']:5d}x  {row['name']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "profile": {k: {kk: vv for kk, vv in v.items() if kk != "top"}
                                               for k, v in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
