"""Time to first audio of the port's streaming synthesis (counterpart of
``scripts/bench_stream.py``).

    python -m viettts_tpu_torch.bench.stream [--iters 3] [--warmup 1] [--out runs/bench/stream.json]

``bench_stream.py``'s measurement on the card: a Synthesizer at
``Config()`` widths on seeded random weights (``bench.seeded``), its
durations pinned to ``DURATION_S`` (80 ms a token, so chunk sizes follow
real speech rather than the random duration model), a long text
(``SENTENCE`` x ``REPEATS``, 530 tokens, past the 256-token chunk cap).
After ``warmup`` runs of each (streamed with both lead settings, then one
shot), the best of ``iters`` runs of: ``synthesize(text)``; ``stream(text)``
with lead chunks of ``LEAD_TOKENS`` tokens (its first chunk, its last, the
samples); ``stream(text, lead_tokens=0)`` (its first chunk).  Each time is
host wall time to the chunk's samples on the host, as a caller receives
them.

The last line is one JSON object with ``bench_stream.py``'s keys (its
arithmetic and rounding; ``backend`` is the card's line) and the port's:
``device``, ``route``, ``iters``, ``warmup``, ``runs_s`` (every timed run
unrounded), ``launches``.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from viettts_tpu_torch.bench.common import (
    card_line,
    parser,
    read_counters,
    resolve_device,
    run_main,
    wgmma_counters,
    zero_counters,
)
from viettts_tpu_torch.bench.seeded import write_checkpoints
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.infer.pipeline import Synthesizer

SENTENCE = "hôm qua em tới trường mẹ dắt tay từng bước. "
REPEATS = 12  # ~12 sentences -> well past the 256-token chunk cap
DURATION_S = 0.08  # seconds a token: a speaking pace
LEAD_TOKENS = 64  # the lead chunk that stream() takes by default
ITERS = 3  # bench_stream.py takes the best of 3 runs
WARMUP = 1


def pin_durations(synth: Synthesizer, seconds: float) -> None:
    """Every token lasts ``seconds``, on the bucketed path and in the lead
    program alike (both call ``synth.duration_model``)."""
    synth.duration_model = lambda batch, **_: torch.full(batch.phonemes.shape, seconds, device=batch.phonemes.device)


def rates(one_shot_s: float, first_s: float, first_full_s: float, total_s: float) -> dict:
    """``bench_stream.py``'s arithmetic on the best times (seconds)."""
    return {
        "one_shot_latency_s": round(one_shot_s, 4),
        "stream_first_chunk_s": round(first_s, 4),
        "stream_first_chunk_full_lead_s": round(first_full_s, 4),
        "lead_chunk_ttfa_speedup": round(first_full_s / first_s, 2),
        "stream_total_s": round(total_s, 4),
        "first_audio_speedup": round(one_shot_s / first_s, 2),
    }


@torch.inference_mode()
def run(cfg: Optional[Config] = None, device="cuda", iters: int = ITERS, warmup: int = WARMUP, seed: int = 0, *,
        repeats: int = REPEATS, lead_tokens: int = LEAD_TOKENS) -> dict:
    """Time one-shot and streamed synthesis of ``SENTENCE * repeats``;
    the shapes default to ``bench_stream.py``'s.  Raises on a card run that
    launched a twin or missed a kernel."""
    cfg = cfg or Config()
    device = resolve_device(str(device))
    with tempfile.TemporaryDirectory(prefix="bench_stream_") as tmp:
        write_checkpoints(cfg, Path(tmp), seed)
        synth = Synthesizer(cfg.replace(ckpt_dir=Path(tmp)), device=device)
    pin_durations(synth, DURATION_S)
    text = SENTENCE * repeats

    def one_shot():
        t0 = time.perf_counter()
        n = len(synth.synthesize(text).wave)
        return time.perf_counter() - t0, n

    def streamed(lead):
        t0, first, n = time.perf_counter(), None, 0
        for res in synth.stream(text, lead_tokens=lead):
            if first is None:
                first = time.perf_counter() - t0
            n += len(res.wave)
        return first, time.perf_counter() - t0, n

    zero_counters()
    for _ in range(warmup):
        streamed(lead_tokens)
        streamed(0)
        one_shot()
    shots = [one_shot() for _ in range(iters)]
    leads = [streamed(lead_tokens) for _ in range(iters)]
    fulls = [streamed(0) for _ in range(iters)]
    route = cfg.hifigan.inference_dtype
    quant = route == "int8"
    launches = read_counters(device, ["ar_decode", "fused_mrf", "bidirectional_lstm"] + (["fused_mrf_int8"] if quant else [])
                             + wgmma_counters(route, int8_static=False))
    full_s, n_samples = min(shots)
    first_s, total_s, n_stream = min(leads)
    first_full = min(fulls)[0]
    return {
        "text_tokens": len(synth.text_to_token_ids(text)),
        "audio_seconds": n_samples / cfg.dsp.sample_rate,
        **rates(full_s, first_s, first_full, total_s),
        "samples_match": bool(n_stream == n_samples),
        "backend": card_line(device),
        "device": card_line(device),
        "route": route,
        "iters": iters,
        "warmup": warmup,
        "runs_s": {"one_shot": [s for s, _ in shots], "stream_first_chunk": [r[0] for r in leads],
                   "stream_total": [r[1] for r in leads], "stream_first_chunk_full_lead": [r[0] for r in fulls]},
        "launches": launches,
    }


def main(argv=None) -> int:
    p = parser("Time to first audio of stream() against one-shot synthesis (bench_stream.py's shapes)", ITERS, WARMUP)
    return run_main("stream", p.parse_args(argv), run)


if __name__ == "__main__":
    sys.exit(main())
