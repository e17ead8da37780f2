"""Profiling and timing hooks of the port's trainers (counterpart of
``viettts_tpu/utils/profiling.py``), and the spans of its serving path.

* ``trace(logdir)``: ``torch.profiler`` over the host and, where there is
  a card, the device, written on exit as a Chrome / TensorBoard trace
  (``*.pt.trace.json``) into ``logdir`` or ``$VIETTTS_PROFILE_DIR``;
  nothing is recorded when neither is set.  The trainers enter it around
  their loops::

      VIETTTS_PROFILE_DIR=/tmp/trace python -m viettts_tpu_torch.train.acoustic ...

* ``annotate(name)``: a named range in that trace (``record_function``).
* ``StepTimer``: steps per second, the device synchronized before the
  clock is read (CUDA work is asynchronous).

And the spans of the serving path.  The benchmark's per-layer metrics
(``perfbench/metrics/``) read the issue spans' self time, the frames
``synth.finalize`` counts and the set-up spans; recorded beside a
``torch.profiler`` trace of the card, the spans name the stage the host
was in at each of the device's idle gaps (PERF.md, section 5):

* ``span(name, kind, [trace,] **attrs)``: a context manager timing a
  stage of a request on ``time.perf_counter_ns`` (the clock the device
  trace is anchored to).  ``kind`` says what the host does there:
  ``issue`` (queues device work), ``wait`` (blocks on the device), ``host``
  (host work only) or ``queue`` (waits for a lock or a queue).  A span
  opened while another is open on the same thread is its child and shares
  its trace id; a root takes ``trace`` (``new_trace()``) or a fresh id.
  Spans of one public call (``synthesize``, ``synthesize_batch``, one
  ``stream``, one batch of the batcher) share one trace id.  Counts are
  attrs of the span where they arise; ``set(**attrs)`` adds them on the way.
  A span records only while a ``torch.profiler`` session is active or
  inside ``recording()``; otherwise it costs one check and a shared no-op
  context, and records nothing.
* ``always_span(...)``: the same, always recorded: set-up and lead-graph
  capture, which happen once.
* ``spans()`` / ``clear()``: the finished spans (``SpanRecord``) in the
  order they finished, the last ``MAX_SPANS`` kept in memory.

A span never calls ``record_function`` (that would put events in the
device trace) and never synchronizes the device.  Recording is
thread-safe: the batcher's worker and HTTP threads record side by side.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

PROFILE_ENV = "VIETTTS_PROFILE_DIR"


@contextlib.contextmanager
def trace(logdir: Optional[str | Path] = None) -> Iterator[None]:
    """Profile the enclosed code into ``logdir`` (or
    ``$VIETTTS_PROFILE_DIR``); a no-op when neither is set."""
    logdir = logdir or os.environ.get(PROFILE_ENV)
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the trace."""
    with record_function(name):
        yield


class StepTimer:
    """Steps per second since construction or ``reset``; ``tick`` only
    counts, ``steps_per_sec`` waits for ``device`` before reading the
    clock."""

    def __init__(self, device: Optional[str | torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def steps_per_sec(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else float("nan")

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0


# ---------------------------------------------------------------------------
# spans of the serving path

SPAN_KINDS = ("issue", "wait", "host", "queue")
MAX_SPANS = 1 << 16


@dataclasses.dataclass
class SpanRecord:
    """One finished span: times are ``time.perf_counter_ns``; ``parent`` is
    the ``id`` of the span it was opened in (None for a root); ``thread``
    is ``threading.get_ident()``."""

    name: str
    kind: str
    trace: int
    id: int
    parent: Optional[int]
    thread: int
    start: int
    end: int
    attrs: Dict[str, Any]


_records: deque = deque(maxlen=MAX_SPANS)
_records_lock = threading.Lock()
_open = threading.local()  # this thread's open spans, innermost last
_ids = itertools.count(1)
_traces = itertools.count(1)
_recording = 0  # open recording() contexts, all threads


def new_trace() -> int:
    """A fresh trace id, for a call whose spans do not nest in one span (a
    stream's chunks, closed at each yield)."""
    return next(_traces)


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, kind: str, trace: Optional[int], attrs: Dict[str, Any]):
        if kind not in SPAN_KINDS:
            raise ValueError(f"span {name!r}: kind {kind!r} is none of {SPAN_KINDS}")
        self.rec = SpanRecord(name, kind, trace or 0, 0, None, 0, 0, 0, attrs)

    def __enter__(self) -> "_Span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec = self.rec
        if stack:
            rec.parent, rec.trace = stack[-1].id, stack[-1].trace
        elif not rec.trace:
            rec.trace = new_trace()
        rec.id, rec.thread = next(_ids), threading.get_ident()
        stack.append(rec)
        rec.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.end = time.perf_counter_ns()
        _open.stack.pop()
        with _records_lock:
            _records.append(rec)
        return False

    def set(self, **attrs) -> None:
        self.rec.attrs.update(attrs)


class _NoSpan:
    """What ``span`` returns when nothing records: enters and sets, doing
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, kind: str, trace: Optional[int] = None, /, **attrs):
    """A span of a request's stage (see the module's docstring); records
    only under ``recording()`` or an active ``torch.profiler`` session."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, kind, trace, attrs)


def always_span(name: str, kind: str, /, **attrs) -> _Span:
    """A span that always records: set-up and lead-graph capture."""
    return _Span(name, kind, None, attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record ``span``s, on every thread, while the context is open."""
    global _recording
    with _records_lock:
        _recording += 1
    try:
        yield
    finally:
        with _records_lock:
            _recording -= 1


def spans() -> List[SpanRecord]:
    """The finished spans, in the order they finished."""
    with _records_lock:
        return list(_records)


def clear() -> None:
    with _records_lock:
        _records.clear()
