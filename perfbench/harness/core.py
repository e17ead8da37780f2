"""One run of one cell: set up, warm up, drive the program for the window,
read the trace, free the program, check its outputs against the reference,
and build the result line."""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.harness import cells, drivers
from perfbench.harness.check import check
from perfbench.harness.flops import peaks_for_name
from perfbench.harness.program import Program, warm
from perfbench.harness.trace import Tracer
from perfbench.harness.weights import seeded_trees

FORBIDDEN = ("jax", "jaxlib", "flax", "viettts_tpu")  # top-level module names, compared whole
METRICS_DIR = cells.BENCH_DIR / "metrics"


def loaded_forbidden() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (nearest rank) of ``values``; a failed
    request is +inf and counts as missing every limit."""
    v = sorted(values)
    if not v:
        return float("nan")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def seeds(seed: int) -> Dict[str, int]:
    """The streams a run draws from its seed."""
    ss = np.random.SeedSequence(int(seed))
    weights, traffic, prenet = (int(s.generate_state(1, np.uint64)[0]) for s in ss.spawn(3))
    return {"weights": weights, "traffic": traffic, "prenet": prenet % 2 ** 31}


def _reader(name: str):
    return cells.load_module(METRICS_DIR / f"{name}.py", "perfbench_metric_").read


class Context:
    """What a per-layer metric's reader reads: the trace, the run's record,
    the configuration's sizes, the card's peaks and the configuration's
    model modules (``cells.Models``, whose counts the rooflines take)."""

    def __init__(self, trace, record, sizes, peaks, hop: int, models):
        self.trace, self.record, self.sizes, self.peaks, self.hop = trace, record, sizes, peaks, hop
        self.models = models

    def traced_dispatches(self) -> List[drivers.Dispatch]:
        """The dispatches that ran wholly inside the traced part."""
        if self.trace is None:
            return []
        a, b = self.trace.span
        return [d for d in self.record.dispatches if d.t0 >= a and d.t1 <= b]

    def host_slowdown(self) -> Optional[float]:
        """How much longer the traced part's calls took for each second of
        audio they returned than the untraced calls before it: the
        profiler's own cost, which the shares of the window divide out."""
        if self.trace is None:
            return None
        before = [d for d in self.record.dispatches if d.t1 <= self.trace.span[0]]
        traced = self.traced_dispatches()

        def per_sample(ds):
            kept = sum(sum(d.kept) for d in ds)
            return sum(d.t1 - d.t0 for d in ds) / kept if kept else None

        a, b = per_sample(traced), per_sample(before)
        return a / b if a and b else None

    def untraced_window_s(self) -> Optional[float]:
        """The traced window's length without the profiler's cost."""
        slowdown = self.host_slowdown()
        if slowdown is None or self.trace.window_s <= 0:
            return None
        return self.trace.window_s / slowdown

    def kept_frames(self, d: drivers.Dispatch) -> List[int]:
        return [k // self.hop for k in d.kept]


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
             also: Sequence[str] = (), program_route: Optional[str] = None, log=print) -> dict:
    """One run of ``cell``.  For ``perfbench/control.py`` only, never for the
    benchmark's runs: each of ``also`` adds the readings of that control
    (``check``'s) on the same requests (``result["also"]``), and
    ``program_route`` runs the program on another vocoder route while the
    reference keeps the one the configuration states."""
    sizes = cell.config["sizes"]
    s = seeds(seed)
    trees = seeded_trees(sizes, s["weights"], device, cell.config["weights"], cell.models)
    program_sizes = dict(sizes, **({"hifigan.inference_dtype": program_route} if program_route else {}))
    program = Program(program_sizes, trees, device, s["prenet"], cell.config.get("program_overrides", []))
    synth = program.synth
    warm(synth, cell.traffic["warmup"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    record = drivers.Record()
    delay = 0.0
    if trace:  # a traced run's window: trace_seconds untraced, then trace_seconds traced
        seconds = min(seconds, 2 * cell.traffic.get("trace_seconds", seconds))
        delay = seconds / 2
    tracer = Tracer(trace, delay)
    tracer.prime()
    driver = drivers.DRIVERS[cell.traffic["driver"]]
    rng = np.random.default_rng(s["traffic"])
    driver(synth, cell.traffic, seed, seconds, rng, tracer, record)
    setup_s = record.window[0] - t_start  # process start to the first timed request
    tracer.stop()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
        name = torch.cuda.get_device_name(device)
    else:
        peak, name = 0, "cpu"
    program.close()
    del synth, program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = check(record, trees, sizes, cell.traffic["warmup"], s["prenet"], device, cell.models)
    mismatches = readings.pop("mismatches")
    for m in mismatches[:5]:
        log(f"mismatch: {m}", file=sys.stderr)
    checks = {k: {"value": readings[k], "limit": cell.limits[k]} for k in cell.limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    window_s = record.window[1] - record.window[0]
    metrics: Dict[str, dict] = {}
    breakdown = None
    if not trace:
        values = {
            "audio_s_per_s": record.audio_samples / sizes["dsp.sample_rate"] / window_s if window_s > 0 else None,
            "first_audio_p95_ms": percentile(record.first_audio_ms, 95) if record.first_audio_ms else None,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            v = values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        t = tracer.result
        peaks = peaks_for_name(name) if device.type == "cuda" else None
        ctx = Context(t, record, sizes, peaks, sizes["dsp.hop_length"], cell.models)
        for m in cell.per_layer:
            v = _reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if t is not None:
            breakdown = {"device_ops": t.top_ops(),
                         "idle_gaps": t.idle_gaps([(d.t0, d.t1) for d in record.dispatches])}
    result = {
        "correct": bool(correct),
        "attempted": int(record.attempted),
        "failed": int(record.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type, "kind": name,
                   "count": 1, "memory_peak_bytes": peak},
    }
    if trace and tracer.result is not None:
        result["device"]["busy_s"] = tracer.result.busy_s
        result["device"]["window_s"] = tracer.result.window_s
    if breakdown is not None:
        result["breakdown"] = breakdown
    calls_ms = [1e3 * (d.t1 - d.t0) for d in record.dispatches]
    result["run"] = {"window_s": window_s, "dispatches": len(record.dispatches),
                     "call_ms_quartiles": [float(v) for v in np.percentile(calls_ms, [25, 50, 75])] if calls_ms else [],
                     "compared_rows": readings["compared_rows"], "compared_tokens": readings["compared_tokens"],
                     "wave_gap_worst_row": readings["wave_gap_worst_row"]}
    if trace and tracer.result is not None:
        result["run"]["trace_clock_skew_s"] = tracer.result.clock_skew_s()
        result["run"]["trace_host_slowdown"] = ctx.host_slowdown()
    if also:
        result["also"] = {c: {k: v for k, v in check(record, trees, sizes, cell.traffic["warmup"], s["prenet"],
                                                      device, cell.models, c).items() if k != "mismatches"}
                          for c in also}
    result["checks"] = checks
    return result
