#!/usr/bin/env python3
"""Time of the four default generator stages (``fused_mrf``, kernels K2 and
K3) on one CUDA GPU, for comparing two checkouts of the port.

    python3 scripts/time_vocoder_stages.py [--reps 20]

B=2 at 128 mel frames, ResBlock1, ``chip_smoke.py``'s seeded stage
weights: per route (bfloat16, float32, int8 with static and with dynamic
scales) the CUDA-event time of the four stages called back to back, the
mean over ``--reps`` calls after one warm-up (host enqueue included, as
the pipeline pays it), and the host time to enqueue them.  Prints the
card's name and power limit, then one JSON line.

``viettts_tpu_torch`` is imported from ``sys.path``: put another checkout
first on ``PYTHONPATH`` to time it, and run two checkouts in turns in one
session to compare them on one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_vocoder_stages: no CUDA device", file=sys.stderr)
        return 1
    sys.path.append(str(REPO))  # chip_smoke.py, after any checkout on PYTHONPATH
    import chip_smoke
    import viettts_tpu_torch
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.ops.mrf import fused_mrf, mrf_walk, prepare_mrf_weights

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, dev, bf16 = Config().hifigan, torch.device("cuda"), torch.bfloat16
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    rng = np.random.default_rng(7)
    calls = {"bfloat16": [], "float32": [], "int8": [], "int8_dynamic": []}
    for C_in, C, k_u, u, L_in, post in chip_smoke.stage_shapes(cfg, 128):
        x = torch.from_numpy(chip_smoke.seeded(rng, 2, L_in, C_in)).to(dev)
        xb = x.to(bf16)
        for route, dtype, inp in (("bfloat16", bf16, xb), ("float32", torch.float32, x)):
            w, ups, pst = chip_smoke.stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, False, dtype)
            calls[route].append((inp, w, dict(upsample=ups, post=pst, compute_dtype=dtype)))
        # the int8 route as chip_smoke.py's K3 check builds it
        w32, ups32, pst32 = chip_smoke.stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, False, torch.float32)
        _, amax = mrf_walk(xb.float().transpose(1, 2), w32, ks, ds, lambda j, y: y.abs().amax(), upsample=ups32)
        w, ups, pst = prepare_mrf_weights(w32, ups32, pst32, bf16, quantize_int8=True)
        for route, act in (("int8", torch.stack(amax)), ("int8_dynamic", None)):
            kw = dict(upsample=ups, post=pst, compute_dtype=bf16, quantize_int8=True, act_scales=act)
            calls[route].append((xb, w, kw))

    result = {"package": str(Path(viettts_tpu_torch.__file__).parent), "card": smi}
    for route, stages in calls.items():
        def run():
            for inp, w, kw in stages:
                fused_mrf(inp, w, ks, ds, **kw)

        ms = chip_smoke.time_ms(run, reps=args.reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        result[route] = {"ms": ms, "enqueue_ms": enqueue_ms}
        print(f"{route}: 4 stages {ms:.3f} ms (host enqueue {enqueue_ms:.3f} ms)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
