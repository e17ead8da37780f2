"""The B=1 vocoder on every route (counterpart of
``scripts/bench_b1_vocoder.py``).

    python -m viettts_tpu_torch.bench.b1_vocoder [--n-frames 1024]

``generator_apply_fused`` at ``HifiGanConfig()`` widths on seeded random
weights and one random mel of 1,024 frames (the JAX script's default
argument, ``:78``), ``K`` = 16 timed runs after one warm-up (``:17``), on
the float32 and bfloat16 routes (kernel K2) and the int8 route with
dynamic and with static activation scales (kernel K3;
``generator_calibrate_int8`` on the same mel), the routes of ``:55-61``.
It measures speed only: which route serves is a quality call made on
trained weights (``tools/validate_int8.py``).

The last line is one JSON object: ``routes`` (per route: ``ms`` the
median run, ``msamples_per_sec``, ``runs_ms`` every run), ``n_frames``,
``device`` and ``launches``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from viettts_tpu_torch.bench.common import (
    card_line,
    check_wave,
    host_runs,
    median,
    parser,
    read_counters,
    resolve_device,
    run_main,
    seeded_generator,
    zero_counters,
)
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.models.hifigan import generator_apply_fused, generator_calibrate_int8

K = 16
N_FRAMES = 1024
WARMUP = 1


@torch.inference_mode()
def run(cfg: Optional[Config] = None, device="cuda", iters: int = K, warmup: int = WARMUP, seed: int = 0, *,
        n_frames: int = N_FRAMES) -> dict:
    """Time each route on one mel; ``n_frames`` defaults to the JAX
    script's."""
    cfg = cfg or Config()
    device = resolve_device(str(device))
    generator = seeded_generator(cfg, device, seed)
    mel = torch.as_tensor(np.random.RandomState(seed).randn(1, n_frames, cfg.acoustic.mel_dim).astype(np.float32)
                          * 0.5, device=device)
    scales = generator_calibrate_int8(generator, mel)
    routes = {
        "float32": dict(compute_dtype=torch.float32),
        "bfloat16": dict(compute_dtype=torch.bfloat16),
        "int8-dynamic": dict(compute_dtype=torch.bfloat16, quantize_int8=True),
        "int8-static": dict(compute_dtype=torch.bfloat16, quantize_int8=True, act_scales=scales),
    }
    zero_counters()
    out = {}
    for name, kw in routes.items():
        check_wave(generator_apply_fused(generator, mel, **kw).cpu(), (1, n_frames * cfg.dsp.hop_length, 1),
                   f"b1_vocoder {name}")
        runs = host_runs(lambda: generator_apply_fused(generator, mel, **kw).cpu(), device, iters, warmup)
        t = median(runs)
        out[name] = {"ms": 1e3 * t, "msamples_per_sec": n_frames * cfg.dsp.hop_length / t / 1e6,
                     "runs_ms": [1e3 * r for r in runs]}
        print(f"B=1 T={n_frames} {name:13s}: {1e3 * t:7.2f} ms ({out[name]['msamples_per_sec']:.1f} Msamples/s)",
              flush=True)
    return {
        "batch": 1,
        "n_frames": n_frames,
        "routes": out,
        "backend": device.type,
        "device": card_line(device),
        "iters": iters,
        "warmup": warmup,
        "launches": read_counters(device, ["fused_mrf", "fused_mrf_int8", "mrf_conv_wgmma", "mrf_conv_wgmma_int8",
                                            "mrf_conv_wgmma_tf32", "mrf_conv_wgmma_int8_dynamic"]),
    }


def main(argv=None) -> int:
    p = parser("The B=1 vocoder per route (scripts/bench_b1_vocoder.py's shapes)", K, WARMUP)
    p.add_argument("--n-frames", type=int, default=N_FRAMES, help=f"mel frames (default {N_FRAMES})")
    args = p.parse_args(argv)
    return run_main("b1_vocoder", args, run, n_frames=args.n_frames)


if __name__ == "__main__":
    sys.exit(main())
