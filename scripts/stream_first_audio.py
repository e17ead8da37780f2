#!/usr/bin/env python3
"""Time to first audio of the port's ``Synthesizer.stream`` on one CUDA GPU,
and its B=1 latency.

    python3 scripts/stream_first_audio.py [--route int8] [--reps 3]

Full default width (``Config()``) on ``chip_smoke.py``'s seeded random
weights, after ``warmup()`` and one unmeasured call of each: the host wall
time from calling ``stream(STREAM_TEXT)`` to its first chunk, and to its
last, and of ``synthesize(SENTENCE)``, over ``--reps`` calls, with their
medians.  Prints the card's name and power limit, then one JSON line.

``viettts_tpu_torch`` is imported from ``sys.path``, so another checkout
put first on ``PYTHONPATH`` is what gets timed; run two checkouts in turns
in one session to compare them on one card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", default="int8", choices=["int8", "bfloat16", "float32"])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_first_audio: no CUDA device", file=sys.stderr)
        return 1
    sys.path.append(str(REPO))  # chip_smoke.py, after any checkout on PYTHONPATH
    import chip_smoke
    import viettts_tpu_torch
    from viettts_tpu_torch.config import Config, apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    cfg = Config()
    with tempfile.TemporaryDirectory(prefix="stream_first_audio_") as tmp:
        chip_smoke.write_checkpoints(cfg, Path(tmp))
        synth = Synthesizer(
            apply_overrides(cfg.replace(ckpt_dir=Path(tmp)), [f"hifigan.inference_dtype={args.route}"]),
            device="cuda",
        )
        synth.warmup()
        list(synth.stream(chip_smoke.STREAM_TEXT))
        synth.synthesize(chip_smoke.SENTENCE)
        latencies = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            synth.synthesize(chip_smoke.SENTENCE)
            latencies.append(1e3 * (time.perf_counter() - t0))
        firsts, totals, chunks = [], [], 0
        for _ in range(args.reps):
            t0 = time.perf_counter()
            first, chunks = None, 0
            for _chunk in synth.stream(chip_smoke.STREAM_TEXT):
                first = first or time.perf_counter() - t0
                chunks += 1
            totals.append(1e3 * (time.perf_counter() - t0))
            firsts.append(1e3 * first)
    print(json.dumps({
        "package": str(Path(viettts_tpu_torch.__file__).parent), "card": smi, "route": args.route,
        "first_audio_ms": float(np.median(firsts)), "first_audio_samples_ms": firsts,
        "total_ms": float(np.median(totals)), "chunks": chunks,
        "b1_latency_ms": float(np.median(latencies)), "b1_latency_samples_ms": latencies,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
