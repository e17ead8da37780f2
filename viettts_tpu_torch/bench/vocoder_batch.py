"""The vocoder's routes per batch size on the card (counterpart of
``scripts/tune_vocoder_batch.py``).

    python -m viettts_tpu_torch.bench.vocoder_batch [--iters 8] [--warmup 1]

``generator_apply_fused`` (kernel K2) at ``HifiGanConfig()`` widths on
seeded random weights and a random mel of 768 frames (``:24``), at
B = 1, 8, 16, 32 and 64 (``:68``), on the float32 and the bfloat16 route,
each timed ``K`` = 8 times after one warm-up: milliseconds and audio
seconds per second; and the bfloat16 route's waveform error against the
float32 route on the first 4 rows (max and mean absolute difference, and
the float32 wave's RMS), as the JAX script prints them.

The JAX script's other two knobs have no counterpart here: the
ConvTranspose fusion (``fuse_upsample``) and the C=128 stage's batch cap
(``fused_max_batch``) choose among TPU programs; K2 always runs the
ConvTranspose as its prologue and takes any batch in one launch per
stage, so nothing is reported for them.

The last line is one JSON object: ``quality`` (``max_abs_dwave``,
``mean_abs_dwave``, ``wave_rms``), ``rows`` (per batch and route: ``ms``
the median run, ``audio_s_per_s``, ``runs_ms`` every run), ``device`` and
``launches``.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

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
from viettts_tpu_torch.models.hifigan import generator_apply_fused

N_FRAMES = 768
K = 8
WARMUP = 1
BATCHES = (1, 8, 16, 32, 64)
QUALITY_ROWS = 4
ROUTES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@torch.inference_mode()
def run(cfg: Optional[Config] = None, device="cuda", iters: int = K, warmup: int = WARMUP, seed: int = 0, *,
        batches: Sequence[int] = BATCHES, n_frames: int = N_FRAMES) -> dict:
    """Time both routes at every batch size; the shapes default to the
    JAX script's."""
    cfg = cfg or Config()
    device = resolve_device(str(device))
    generator = seeded_generator(cfg, device, seed)
    hop, sr = cfg.dsp.hop_length, cfg.dsp.sample_rate
    mel_all = torch.as_tensor(np.random.RandomState(seed).randn(max(batches), n_frames, cfg.acoustic.mel_dim)
                              .astype(np.float32), device=device)

    zero_counters()
    f32 = generator_apply_fused(generator, mel_all[:QUALITY_ROWS]).cpu()
    b16 = generator_apply_fused(generator, mel_all[:QUALITY_ROWS], torch.bfloat16).cpu()
    for name, wave in (("float32", f32), ("bfloat16", b16)):
        check_wave(wave, (QUALITY_ROWS, n_frames * hop, 1), f"vocoder_batch {name}")
    d = (f32 - b16).abs()
    quality = {"max_abs_dwave": float(d.max()), "mean_abs_dwave": float(d.mean()),
               "wave_rms": float(torch.sqrt(torch.mean(f32 * f32)))}
    rows = []
    for batch in batches:
        mel = mel_all[:batch]
        audio_s = batch * n_frames * hop / sr
        for route, dtype in ROUTES.items():
            runs = host_runs(lambda: generator_apply_fused(generator, mel, dtype).cpu(), device, iters, warmup)
            t = median(runs)
            rows.append({"batch": batch, "route": route, "ms": 1e3 * t, "audio_s_per_s": audio_s / t,
                         "runs_ms": [1e3 * r for r in runs]})
    return {
        "n_frames": n_frames,
        "quality": quality,
        "rows": rows,
        "backend": device.type,
        "device": card_line(device),
        "iters": iters,
        "warmup": warmup,
        "launches": read_counters(device, ["fused_mrf", "mrf_conv_wgmma", "mrf_conv_wgmma_tf32"]),
    }


def main(argv=None) -> int:
    p = parser("Vocoder routes per batch size (scripts/tune_vocoder_batch.py's shapes)", K, WARMUP)
    return run_main("vocoder_batch", p.parse_args(argv), run)


if __name__ == "__main__":
    sys.exit(main())
