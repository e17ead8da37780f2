"""The controls, on the card: the reference at bfloat16 put in the program's
place fails a number of the cell that the program as configured passes
(the durations or the log-mel), the reference vocoder in e4m3 fails the
waveform's, and so does the program's own int8 vocoder route, the step
below the configuration's bfloat16.  Run with ``-m gpu`` on a machine with a
card (``python -m pytest perfbench/tests -m gpu``); here the cell's traffic
is cut to 16 texts a call so that a test run holds it."""

import copy
import time

import pytest
import torch

from perfbench.harness import cells
from perfbench.harness.core import run_cell


def _cell():
    c = cells.load("infore.bulk64")
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic["batch"] = 16
    c.traffic["warmup"] = [{"batch_sizes": [16], "token_buckets": [256], "frame_buckets": [1024]}]
    return c


def _fails(checks):
    return [k for k, c in checks.items() if not c["value"] <= c["limit"]]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_controls_fail_where_the_program_passes(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    cell = _cell()
    res = run_cell(cell, seed, 3.0, False, device, time.perf_counter(), also=("bfloat16", "float8"),
                   log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    for control, number in (("bfloat16", "mel_gap"), ("float8", "wave_gap")):
        low = {k: {"value": v, "limit": cell.limits[k]} for k, v in res["also"][control].items() if k in cell.limits}
        assert number in _fails(low), (control, low)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_programs_int8_route_fails_the_waveform(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = run_cell(_cell(), seed, 3.0, False, torch.device("cuda", 0), time.perf_counter(), program_route="int8",
                   log=lambda *a, **k: None)
    assert "wave_gap" in _fails(res["checks"]), res["checks"]
