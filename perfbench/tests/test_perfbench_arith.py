"""The metric arithmetic: percentiles with failures at +inf, the model
modules' frozen counts equal to the program's own (the yardstick is a
copy), rooflines."""

import math

from perfbench.harness import flops
from perfbench.harness.core import percentile
from perfbench.harness.trace import Trace, _union_ns
from perfbench.reference.models import hifigan, viettts_acoustic, viettts_duration
from tests_sizes import SIZES


def test_percentile_counts_failures_as_missing_every_limit():
    lat = [10.0] * 94 + [20.0] + [float("inf")] * 5
    assert percentile(lat, 95) == 20.0
    assert math.isinf(percentile(lat + [float("inf")], 95))
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0


def test_frozen_counts_equal_the_programs():
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.utils import flops as pf

    cfg = Config()
    for n, f in ((37, 150), (256, 1024)):
        assert viettts_duration.flops(SIZES, n) == pf.duration_flops(cfg, n)
        assert viettts_acoustic.decode_flops(SIZES, n, f) == pf.acoustic_decode_flops(cfg, n, f)
        assert hifigan.generator_flops(SIZES, f) == pf.generator_flops(cfg, f)
    b, L, H, P, D = 64, 1024, 512, 256, 80
    flop, bytes_ = viettts_acoustic.ar_decode_counts(SIZES, b * L)
    ms, _ = pf.ar_decode_bound(b, L, H, P, D, pf.H100_SXM)
    assert abs(1e3 * flops.bound_seconds(flop, bytes_, flops.H100_SXM.fp32, flops.H100_SXM) - ms) < 1e-9
    assert flops.peaks_for_name("NVIDIA H100 80GB HBM3") == flops.H100_SXM


def test_vocoder_counts_leave_out_conv_pre():
    f = 300
    with_pre = hifigan.generator_flops(SIZES, f)
    stage_flop, stage_bytes = hifigan.stage_counts(SIZES, f)
    assert with_pre - stage_flop == 2 * f * 80 * 512 * 7
    assert stage_bytes == 2 * (300 * 512 + 2400 * 256 + 2400 * 256 + 19200 * 128 + 19200 * 128 + 38400 * 64
                               + 38400 * 64 + 76800 * 1)


def test_busy_is_the_union_of_device_intervals():
    assert _union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    t = Trace(window_s=1e-7, busy_s=3e-8, ops=[("k", 0, 10), ("k", 5, 15), ("Memcpy HtoD", 30, 10), ("k", 52, 5),
                                               ("k", 58, 2), ("k", 68, 2)],
              host=[("cudaLaunchKernel", 22, 5), ("cudaStreamSynchronize", 41, 10)], span=(0.0, 1e-7), clock=(0, 0.0))
    assert len(t.kernels()) == 5
    assert abs(t.device_seconds(["k"]) - 34e-9) < 1e-18
    gaps = t.idle_gaps([(0.0, 35e-9), (60e-9, 80e-9)])  # two calls
    assert [g[0] for g in gaps[:3]] == ["cudaStreamSynchronize between calls", "cudaLaunchKernel in a call",
                                        "no CUDA call (host in Python) in a call"]
    assert all(abs(g[1] - v) < 1e-15 for g, v in zip(gaps, (12e-9, 10e-9, 8e-9, 1e-9)))
    assert t.clock_skew_s() == 0.0


def test_a_run_traces_one_part():
    import time

    from perfbench.harness.trace import Tracer

    t = Tracer(True)
    t.prime()
    t.before(time.perf_counter())
    assert t.prof is not None
    t.stop()
    first = t.result
    assert first is not None and t.prof is None
    t.before(time.perf_counter())  # a later call starts no second part
    assert t.prof is None and t.result is first


def test_the_profilers_cost_is_divided_out():
    from perfbench.harness import drivers
    from perfbench.harness.core import Context
    from perfbench.harness.trace import Tracer

    t = Tracer(True, delay=1.0)
    t.before(10.0)
    t.before(10.5)
    assert t.prof is None  # the first second is untraced
    rec = drivers.Record()
    # untraced: 2 calls of 0.5 s for 1,000 samples each; traced: 2 calls of 0.6 s
    for t0, dur in ((0.0, 0.5), (0.5, 0.5), (1.0, 0.6), (1.6, 0.6)):
        rec.dispatches.append(drivers.Dispatch("batch", ["a"], [], [1000], {}, t0, t0 + dur))
    trace = Trace(window_s=1.2, busy_s=0.5, ops=[("k", 0, 10)], host=[], span=(1.0, 2.2))
    ctx = Context(trace, rec, SIZES, None, 256, None)
    assert abs(ctx.host_slowdown() - 1.2) < 1e-12 and abs(ctx.untraced_window_s() - 1.0) < 1e-12
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("idle", Path(__file__).resolve().parents[1] / "metrics" / "_idle.py")
    idle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(idle)
    assert abs(idle.idle_pct(ctx) - 50.0) < 1e-9
