"""The device trace of a traced run, reduced to what the per-layer
metrics and the breakdown read.

A traced run's window is ``2 * trace_seconds`` of the cell's traffic: the
first half untraced, the second traced.  ``torch.profiler`` records the
device's activity there (CUPTI on the card: kernels, copies, memsets and the
CUDA runtime calls that issued them), in memory (no trace file).  On a card
it records no host operators: their callbacks (some 15,600 a bulk call)
slowed a call by ~40%.  Its per-launch records still slow the host, by some
20% in a bulk call, which the untraced half measures (``Context``'s
``host_slowdown``).  From its raw events:

* device operations: kernels, copies and memsets, with names and times;
* ``busy_s``: the union of their intervals; ``window_s``: the traced span;
* the longest idle gaps of the device, each named by the CUDA runtime call
  in flight at its middle (or none: the host in Python), and by whether it
  fell inside one of the harness's calls into the program or between two.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, int, int]]  # device operations: (name, start ns, duration ns), by start
    host: List[Tuple[str, int, int]]  # host events (CUDA runtime calls): (name, start ns, duration ns)
    span: Tuple[float, float]  # host clock (perf_counter) of the traced part
    clock: Tuple[int, float] = (0, 0.0)  # one instant on the trace's clock (ns) and on perf_counter

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def device_seconds(self, patterns: Sequence[str]) -> Optional[float]:
        """Summed seconds of the kernels whose name holds one of
        ``patterns``; None where none ran."""
        ns = [d for name, _, d in self.kernels() if any(p in name for p in patterns)]
        return 1e-9 * sum(ns) if ns else None

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for name, _, d in self.ops:
            total[name] += d
        return [[k[:160], 1e-9 * v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def clock_skew_s(self) -> Optional[float]:
        """Seconds from the traced part's start, on perf_counter carried to
        the trace's clock, to its first device operation: small and positive
        where the two clocks agree, which the gaps' naming assumes."""
        if not self.ops:
            return None
        ns0, pc0 = self.clock
        return 1e-9 * (self.ops[0][1] - ns0) - (self.span[0] - pc0)

    def idle_gaps(self, calls: Sequence[Tuple[float, float]] = (), n: int = 10) -> List[List]:
        """The ``n`` longest gaps between device operations, each named by
        the host event in flight at its middle and by whether that middle
        falls inside one of ``calls`` (perf_counter intervals)."""
        if not self.ops:
            return []
        gaps, cur_end = [], None
        for name, s, d in self.ops:
            if cur_end is not None and s > cur_end:
                gaps.append((s - cur_end, cur_end, s))
            cur_end = s + d if cur_end is None else max(cur_end, s + d)
        gaps.sort(reverse=True)
        hs = np.array([h[1] for h in self.host], np.int64)
        he = hs + np.array([h[2] for h in self.host], np.int64)
        ns0, pc0 = self.clock
        spans = [(ns0 + int(1e9 * (a - pc0)), ns0 + int(1e9 * (b - pc0))) for a, b in calls]
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) // 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            what = self.host[min(inside, key=lambda i: self.host[i][2])][0] if len(inside) else \
                "no CUDA call (host in Python)"
            where = "in a call" if any(s0 <= mid <= s1 for s0, s1 in spans) else "between calls"
            out.append([f"{what} {where}"[:160], 1e-9 * length])
        return out


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Tracer:
    """Starts the profiler at the first ``before`` that comes ``delay``
    seconds or more after the first, and stops it at ``stop``: one traced
    part a run.  Disabled, it does nothing."""

    def __init__(self, enabled: bool, delay: float = 0.0):
        self.enabled = enabled
        self.delay = delay
        self.first: Optional[float] = None
        self.prof = None
        self.started: Optional[float] = None
        self.clock: Tuple[int, float] = (0, 0.0)
        self.result: Optional[Trace] = None

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]

    def prime(self) -> None:
        """Start and stop the profiler once, so that its first start (which
        loads CUPTI, seconds) falls in the set-up and not in the window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.ones(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)

    def before(self, now: float) -> None:
        if not self.enabled or self.prof is not None or self.result is not None:
            return
        if self.first is None:
            self.first = now
        if now - self.first < self.delay:
            return
        import torch
        from torch.profiler import profile

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.started = time.perf_counter()
        self.clock = (time.time_ns(), time.perf_counter())  # the profiler's clock is the wall clock

    def stop(self) -> None:
        if self.prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        stopped = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.result = _reduce(self.prof, (self.started, stopped), self.clock)
        self.prof = None


def _reduce(prof, span: Tuple[float, float], clock: Tuple[int, float]) -> Trace:
    from torch.autograd import DeviceType

    ops, host = [], []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        raw = ((e.name(), e.device_type(), int(e.start_ns()), int(e.duration_ns())) for e in results.events())
    else:  # the parsed events: microsecond times
        raw = ((e.name, e.device_type, int(1e3 * e.time_range.start), int(1e3 * e.time_range.elapsed_us()))
               for e in prof.events())
    for name, kind, start, dur in raw:
        if kind == DeviceType.CUDA and name.startswith("perfbench."):
            continue  # the device-side copy of a harness span, no operation
        if kind == DeviceType.CUDA:
            ops.append((name, start, dur))
        elif dur > 0:
            host.append((name, start, dur))
    ops.sort(key=lambda o: o[1])
    busy = _union_ns([(s, s + d) for _, s, d in ops])
    return Trace(window_s=span[1] - span[0], busy_s=1e-9 * busy, ops=ops, host=host, span=span, clock=clock)
