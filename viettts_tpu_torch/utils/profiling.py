"""Profiling and timing hooks of the port's trainers (counterpart of
``viettts_tpu/utils/profiling.py``).

* ``trace(logdir)``: ``torch.profiler`` over the host and, where there is
  a card, the device, written on exit as a Chrome / TensorBoard trace
  (``*.pt.trace.json``) into ``logdir`` or ``$VIETTTS_PROFILE_DIR``;
  nothing is recorded when neither is set.  The trainers enter it around
  their loops::

      VIETTTS_PROFILE_DIR=/tmp/trace python -m viettts_tpu_torch.train.acoustic ...

* ``annotate(name)``: a named range in that trace (``record_function``).
* ``StepTimer``: steps per second, the device synchronized before the
  clock is read (CUDA work is asynchronous).
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

import torch
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
