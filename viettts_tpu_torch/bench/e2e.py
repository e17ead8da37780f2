"""End-to-end synthesis benchmark of the port (counterpart of ``bench.py``).

    python -m viettts_tpu_torch.bench.e2e [--iters 5] [--warmup 2] [--out runs/bench/e2e.json]

``bench.py``'s headline metric on the card: wall seconds per second of
audio (real-time factor) of one utterance of 256 random tokens through the
whole chain at ``Config()`` widths on seeded random weights: the duration
model, its durations scaled to 1,024 frames in all as ``bench.py`` scales
them (so kernel K1 decodes exactly 1,024 frames), the acoustic decode and
the vocoder of ``Config()``'s route (kernel K2 in bfloat16); 2 warm-ups,
then 5 timed runs (``bench.py:24-30``).  The calls are the Synthesizer's:
``DurationModel``, ``AcousticModel.inference`` and
``generator_apply_fused``.

The last line is one JSON object with ``bench.py``'s four keys
(``metric``, ``value``: the median run's RTF, ``unit``, ``vs_baseline``:
``TARGET_RTF / value``, above 1 beats the 0.01 target of BASELINE.json),
the keys ``bench.py`` writes to ``benchmarks/results.json``
(``end_to_end_rtf``, ``vocoder_samples_per_sec``,
``acoustic_mel_frames_per_sec``, ``batch``, ``n_frames``, ``backend``,
``mfu``) and the port's: ``device`` (the card's line), ``route``,
``runs_s`` (every timed run), ``stage_ms`` (the median of each stage over
the timed runs: duration, decode, vocoder; CUDA events), ``launches``.
``bench.py`` times the vocoder and the decode in chains of their own; here
they are stages of the timed runs.  ``mfu`` holds ``utils.flops.
mfu_report`` against the card's peaks (the pipeline and the vocoder at the
route's, the decode at TF32's), None on the CPU.
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
    stage_medians,
    wgmma_counters,
    zero_counters,
)
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.models.hifigan import generator_apply_fused, generator_calibrate_int8
from viettts_tpu_torch.utils.flops import acoustic_decode_flops, generator_flops, pipeline_flops

TARGET_RTF = 0.01
N_FRAMES = 1024  # ~16.4 s of audio per utterance at 62.5 frames/s
N_TOKENS = 256
BATCH = 1
WARMUP = 2
ITERS = 5
VOCAB = 93  # token ids are drawn below this, as bench.py draws them
PRENET_SEED = 42  # bench.py's prenet key


def rates(cfg, batch: int, n_frames: int, elapsed: float, t_voc: float, t_ac: float) -> dict:
    """``bench.py``'s arithmetic on one set of timings (seconds: a whole
    run, its vocoder, its decode)."""
    audio_seconds = batch * n_frames * cfg.dsp.hop_length / cfg.dsp.sample_rate
    rtf = elapsed / audio_seconds
    return {
        "metric": "end_to_end_rtf",
        "value": rtf,
        "unit": "seconds_compute_per_second_audio",
        "vs_baseline": TARGET_RTF / rtf,
        "end_to_end_rtf": rtf,
        "vocoder_samples_per_sec": batch * n_frames * cfg.dsp.hop_length / t_voc,
        "acoustic_mel_frames_per_sec": batch * n_frames / t_ac,
        "audio_seconds": audio_seconds,
    }


@torch.inference_mode()
def run(cfg: Optional[Config] = None, device="cuda", iters: int = ITERS, warmup: int = WARMUP, seed: int = 0, *,
        n_tokens: int = N_TOKENS, n_frames: int = N_FRAMES, batch: int = BATCH) -> dict:
    """Time the chain ``iters`` times after ``warmup`` runs; the shapes
    default to ``bench.py``'s.  Raises on a card run that launched a twin
    or missed a kernel, and on a non-finite waveform."""
    cfg = cfg or Config()
    device = resolve_device(str(device))
    duration, acoustic, generator = seeded_models(cfg, device, seed)
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, VOCAB, (batch, n_tokens)), dtype=torch.long, device=device)
    lengths = torch.full((batch,), n_tokens, dtype=torch.long, device=device)
    route = cfg.hifigan.inference_dtype
    compute_dtype, quant = route_of(route)
    act_scales = None
    if quant:  # serving calibrates the static int8 scales first (Synthesizer.warmup)
        cal = rng.randn(1, n_frames, cfg.acoustic.mel_dim).astype(np.float32) * 0.5
        act_scales = generator_calibrate_int8(generator, torch.as_tensor(cal, device=device))
    marks, waves = [], []
    chain = forced_chain(duration, acoustic, lambda mel: generator_apply_fused(
        generator, mel, compute_dtype, quantize_int8=quant, act_scales=act_scales), toks, lengths, n_frames,
        PRENET_SEED, marks)

    zero_counters()
    runs = host_runs(lambda: waves.append(chain()), device, iters, warmup)
    launches = read_counters(device, ["ar_decode", "fused_mrf", "bidirectional_lstm"] + (["fused_mrf_int8"] if quant else [])
                             + wgmma_counters(route))
    check_wave(waves[-1], (batch, n_frames * cfg.dsp.hop_length, 1), "e2e")
    stage_ms, per_run = stage_medians(marks[warmup:])
    elapsed, t_voc, t_ac = median(runs), stage_ms["vocoder"] / 1e3, stage_ms["decode"] / 1e3
    return {
        **rates(cfg, batch, n_frames, elapsed, t_voc, t_ac),
        "batch": batch,
        "n_frames": n_frames,
        "backend": device.type,
        "mfu": {
            "pipeline": mfu(pipeline_flops(cfg, n_tokens, n_frames, batch), elapsed, device, route),
            "vocoder": mfu(generator_flops(cfg, n_frames, batch), t_voc, device, route),
            "acoustic": mfu(acoustic_decode_flops(cfg, n_tokens, n_frames, batch), t_ac, device, "float32"),
        },
        "device": card_line(device),
        "route": route,
        "n_tokens": n_tokens,
        "iters": iters,
        "warmup": warmup,
        "runs_s": runs,
        "stage_ms": stage_ms,
        "stage_runs_ms": per_run,
        "launches": launches,
    }


def main(argv=None) -> int:
    p = parser("End-to-end RTF of the port (bench.py's shapes)", ITERS, WARMUP)
    return run_main("e2e", p.parse_args(argv), run)


if __name__ == "__main__":
    sys.exit(main())
