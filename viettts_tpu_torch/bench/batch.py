"""Batched synthesis throughput of the port (counterpart of
``scripts/bench_batch.py``: BASELINE.json config 5, "64-utterance batch
through full text->mel->waveform pipeline").

    python -m viettts_tpu_torch.bench.batch [--vocoder-dtype {float32,bfloat16,int8}] [--int8-static]

64 utterances of 256 random tokens, durations scaled to 768 frames each
(``scripts/bench_batch.py:20-23``), ``Config()`` widths, seeded random
weights: the full pipeline (duration model, the acoustic decode through
kernel K1, launches of up to 64 rows, and the vocoder of the route) and
the vocoder alone on a zero mel, each timed ``K`` = 4 times after one
warm-up; audio seconds per wall second, the vocoder's samples per second,
and, off the float32 route, the route's waveform error against the
float32 vocoder on a random mel (a check of the route on random weights;
trained weights: ``tools/validate_int8.py``).  ``--int8-static``
calibrates static int8 activation scales on a held-in random mel, as
serving does.

The last line is one JSON object with the keys ``scripts/bench_batch.py``
writes to ``benchmarks/batch_results.json`` (the ``mfu`` entries through
``utils.flops.mfu_report`` against the card's peaks, at the route's peak;
``vocoder_actual_issued`` counts what K2/K3 issue, tiles included) and the
port's: ``device``, ``runs_full_ms`` and ``runs_vocoder_ms`` (every timed
run), ``stage_ms`` (the median full run's duration, decode and vocoder
milliseconds, CUDA events) and ``launches``.  ``decode_sub_batch`` is the
rows of one K1 launch.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from viettts_tpu_torch.bench.common import (
    card_line,
    check_wave,
    forced_chain,
    host_runs,
    median,
    mfu,
    parser,
    read_counters,
    resolve_device,
    route_of,
    run_main,
    seeded_models,
    sm_count,
    stage_medians,
    zero_counters,
)
from viettts_tpu_torch.config import Config, apply_overrides
from viettts_tpu_torch.models.hifigan import generator_apply_fused, generator_calibrate_int8
from viettts_tpu_torch.ops.ar_decoder import MAX_ROWS
from viettts_tpu_torch.utils.flops import generator_flops, generator_issued_flops, pipeline_flops

BATCH = 64
N_TOKENS = 256
N_FRAMES = 768  # ~12.3 s per utterance (the corpus max_wave_len)
K = 4
WARMUP = 1
VOCAB = 93
PRENET_SEED = 7  # scripts/bench_batch.py's prenet key


def rates(cfg, batch: int, n_frames: int, t_full: float, t_voc: float) -> dict:
    """``scripts/bench_batch.py``'s arithmetic on one set of timings
    (seconds: the full pipeline, the vocoder alone)."""
    audio_secs = batch * n_frames * cfg.dsp.hop_length / cfg.dsp.sample_rate
    return {
        "batch": batch,
        "frames_per_utt": n_frames,
        "audio_seconds_per_batch": audio_secs,
        "full_pipeline_ms": t_full * 1e3,
        "full_pipeline_rtf": t_full / audio_secs,
        "full_pipeline_audio_secs_per_sec": audio_secs / t_full,
        "vocoder_ms": t_voc * 1e3,
        "vocoder_samples_per_sec": batch * n_frames * cfg.dsp.hop_length / t_voc,
    }


def _rel_errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    rms = float(torch.sqrt(torch.mean(ref * ref)))
    return {
        "waveform_rel_rms_error_vs_f32": float(torch.sqrt(torch.mean((got - ref) ** 2))) / max(rms, 1e-12),
        "waveform_max_abs_error_vs_f32": float((got - ref).abs().max()),
    }


@torch.inference_mode()
def run(cfg: Optional[Config] = None, device="cuda", iters: int = K, warmup: int = WARMUP, seed: int = 0, *,
        vocoder_dtype: Optional[str] = None, int8_static: bool = False,
        batch: int = BATCH, n_tokens: int = N_TOKENS, n_frames: int = N_FRAMES) -> dict:
    """Time the full pipeline, then the vocoder alone, ``iters`` times
    each after ``warmup`` runs; the shapes default to
    ``scripts/bench_batch.py``'s."""
    cfg = cfg or Config()
    if vocoder_dtype is not None:
        cfg = apply_overrides(cfg, [f"hifigan.inference_dtype={vocoder_dtype}"])
    device = resolve_device(str(device))
    duration, acoustic, generator = seeded_models(cfg, device, seed)
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, VOCAB, (batch, n_tokens)), dtype=torch.long, device=device)
    lengths = torch.full((batch,), n_tokens, dtype=torch.long, device=device)
    route = cfg.hifigan.inference_dtype
    compute_dtype, quant = route_of(route)
    D = cfg.acoustic.mel_dim
    act_scales = None
    if quant and int8_static:
        cal = rng.randn(4, n_frames, D).astype(np.float32) * 0.5
        act_scales = generator_calibrate_int8(generator, torch.as_tensor(cal, device=device))

    def vocode(mel):
        return generator_apply_fused(generator, mel, compute_dtype, quantize_int8=quant, act_scales=act_scales)

    marks, waves = [], []
    chain = forced_chain(duration, acoustic, vocode, toks, lengths, n_frames, PRENET_SEED, marks)
    mel0 = torch.zeros(batch, n_frames, D, device=device)
    zero_counters()
    runs_full = host_runs(lambda: waves.append(chain()), device, iters, warmup)
    runs_voc = host_runs(lambda: vocode(mel0).cpu(), device, iters, warmup)
    launches = read_counters(device, ["ar_decode", "fused_mrf"] + (["fused_mrf_int8"] if quant else []))
    check_wave(waves[-1], (batch, n_frames * cfg.dsp.hop_length, 1), "batch")

    quality = None
    if quant or compute_dtype != torch.float32:
        melq = torch.as_tensor(rng.randn(2, n_frames, D).astype(np.float32) * 0.5, device=device)
        quality = _rel_errors(vocode(melq), generator_apply_fused(generator, melq))
    t_full, t_voc = median(runs_full), median(runs_voc)
    issued_route = "int8" if quant else ("float32" if compute_dtype == torch.float32 else "bfloat16")
    return {
        **rates(cfg, batch, n_frames, t_full, t_voc),
        "vocoder_dtype": route,
        "int8_scales": ("static" if act_scales is not None else "dynamic") if quant else None,
        "vocoder_quality": quality,
        "vocoder_quality_trained_weights": "python -m viettts_tpu_torch.tools.validate_int8 (its --out JSON)",
        "mfu": {
            "pipeline": mfu(pipeline_flops(cfg, n_tokens, n_frames, batch), t_full, device, route),
            "vocoder": mfu(generator_flops(cfg, n_frames, batch), t_voc, device, route),
            "vocoder_actual_issued": mfu(
                generator_issued_flops(cfg, n_frames, batch, issued_route, sm_count(device)), t_voc, device, route),
        },
        "decode_sub_batch": min(batch, MAX_ROWS),
        "backend": device.type,
        "device": card_line(device),
        "n_tokens": n_tokens,
        "iters": iters,
        "warmup": warmup,
        "runs_full_ms": [1e3 * t for t in runs_full],
        "runs_vocoder_ms": [1e3 * t for t in runs_voc],
        "stage_ms": stage_medians(marks[warmup:])[0],
        "launches": launches,
    }


def main(argv=None) -> int:
    p = parser("64-utterance batch throughput of the port (scripts/bench_batch.py's shapes)", K, WARMUP)
    p.add_argument("--vocoder-dtype", default=None, choices=["float32", "bfloat16", "int8"],
                   help="override hifigan.inference_dtype for the serving route")
    p.add_argument("--int8-static", action="store_true",
                   help="calibrated static activation scales for the int8 route")
    args = p.parse_args(argv)
    return run_main("batch", args, run, vocoder_dtype=args.vocoder_dtype, int8_static=args.int8_static)


if __name__ == "__main__":
    sys.exit(main())
