#!/usr/bin/env python3
"""Where the MRF convs of the int8 (K3) and bf16 (K2) routes spend their
time on the card.

    python3 scripts/probe_conv_pipeline.py

1. Per generator stage of the default ``Config()`` (B=2 at 128 mel frames
   and B=1 at chip_smoke.py's 158; ResBlock1; seeded random weights): the
   host time to enqueue one ``fused_mrf`` call (no synchronisation), its
   CUDA-event time, and the device time of its kernels summed by
   ``torch.profiler``, on the int8 route (static and dynamic scales) and
   the bf16 route.
2. One MRF conv at each stage's width (k=3 d=1 and k=11 d=5, B=2), with
   ``csrc/mrf_int8.cu`` built from the sources in variants: as it is; a
   4-deep weight ring; 128-channel chunks; and two diagnostics that give
   wrong results by design and are timed only: the mma instructions
   removed (the pipeline without its tensor work) and the quantize
   arithmetic removed.  Time per launch from CUDA events around a CUDA
   graph of 30 launches (launched one by one from the host, events would
   measure the host's launch rate, part 3, for every conv shorter than
   it).
3. The host time of one conv launch through ctypes.

Needs a CUDA device and nvcc; the variants build (in parallel) into the
git-ignored ``viettts_tpu_torch/_build/variants``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the stage shapes, weights and timing of chip_smoke.py's kernel checks
from chip_smoke import MAIN_PATH_FRAMES, seeded, stage_shapes, stage_weights, time_ms  # noqa: E402

MMA = "mma_s8(acc[mi][ni], af[0][mi], bfr[0][ni][0], bfr[0][ni][1]);"
QUANT = """          float f = __fmul_rn(a[j], inv);
          if (!dynamic) f = fminf(fmaxf(f, -127.f), 127.f);
          word |= (unsigned)(__float2int_rn(f) & 0xff) << (8 * j);"""


def device_ms(fn, reps=5):
    """Device time of ``fn``'s kernels per call, summed by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0) or 0) for e in prof.key_averages()
             if e.device_type != DeviceType.CPU)
    return us / 1e3 / reps


def graph_ms(launch, reps=30, replays=3):
    """Time per launch of ``launch(stream)``, captured ``reps`` times in a
    CUDA graph and replayed: the card's time without the host's."""
    import torch

    launch(torch.cuda.current_stream().cuda_stream)  # first call: the kernel's set-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(reps):
            launch(stream)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def host_ms(fn, reps=10):
    """Host time to enqueue one call of ``fn`` (the queue does not fill)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def stages(dev):
    import numpy as np
    import torch

    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.ops.mrf import fused_mrf, mrf_walk, prepare_mrf_weights

    cfg = Config().hifigan
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    bf16 = torch.bfloat16
    rng = np.random.default_rng(2)
    for B, T in ((2, 128), (1, MAIN_PATH_FRAMES)):
        total = {}
        for i, (C_in, C, k_u, u, L_in, post) in enumerate(stage_shapes(cfg, T)):
            w32, ups32, pst32 = stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, False, torch.float32)
            x = torch.from_numpy(seeded(rng, B, L_in, C_in)).to(dev, bf16)
            _, amax = mrf_walk(x.float().transpose(1, 2), w32, ks, ds, lambda j, y: y.abs().amax(), upsample=ups32)
            w8, u8, p8 = prepare_mrf_weights(w32, ups32, pst32, bf16, quantize_int8=True)
            wb, ub, pb = prepare_mrf_weights(w32, ups32, pst32, bf16)
            act = torch.stack(amax)
            routes = {
                "int8 static": lambda: fused_mrf(x, w8, ks, ds, upsample=u8, post=p8, compute_dtype=bf16,
                                                 quantize_int8=True, act_scales=act),
                "int8 dynamic": lambda: fused_mrf(x, w8, ks, ds, upsample=u8, post=p8, compute_dtype=bf16,
                                                  quantize_int8=True),
                "bf16": lambda: fused_mrf(x, wb, ks, ds, upsample=ub, post=pb, compute_dtype=bf16),
            }
            for name, fn in routes.items():
                row = (host_ms(fn), time_ms(fn, reps=10), device_ms(fn))
                total[name] = [a + b for a, b in zip(total.get(name, (0.0, 0.0, 0.0)), row)]
                print(f"B={B} {T} frames stage {i} {name}: host enqueue {row[0]:.3f} ms, "
                      f"events {row[1]:.3f} ms, device {row[2]:.3f} ms", flush=True)
        for name, (h, e, d) in total.items():
            print(f"B={B} {T} frames, 4 stages, {name}: host enqueue {h:.3f} ms, events {e:.3f} ms, "
                  f"device {d:.3f} ms", flush=True)


def build_variants():
    """{name: ctypes library} of csrc/mrf_int8.cu in each variant."""
    from viettts_tpu_torch.ops import _build

    hdr = (_build.CSRC_DIR / "mrf_common.cuh").read_text()
    cu = (_build.CSRC_DIR / "mrf_int8.cu").read_text()
    assert MMA in hdr and QUANT in hdr and "constexpr int STAGES = 3;" in hdr
    variants = {
        "as is": (hdr, cu),
        "ring 4": (hdr.replace("constexpr int STAGES = 3;", "constexpr int STAGES = 4;"), cu),
        "chunks 128": (hdr, cu.replace("launch_tile<Int8Mma<64>>", "launch_tile<Int8Mma<128>>")),
        "no mma": (hdr.replace(MMA, "acc[mi][ni][0] += (int)(af[0][mi][0] ^ bfr[0][ni][0]);"), cu),
        "no quantize": (hdr.replace(QUANT, "          word |= (__float_as_uint(a[j]) >> 24) << (8 * j);"), cu),
    }
    procs = {}
    for i, (name, (h, c)) in enumerate(variants.items()):
        d = _build.BUILD_DIR / "variants" / str(i)
        d.mkdir(parents=True, exist_ok=True)
        # a namespace of its own: the libraries' C++ symbols (kernel stubs,
        # the once-per-kernel set-up) must not resolve to another's copy
        (d / "mrf_common.cuh").write_text(h.replace("namespace viettts", f"namespace viettts_v{i}"))
        (d / "mrf_int8.cu").write_text(c.replace("viettts::", f"viettts_v{i}::"))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / "mrf_int8.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.viettts_mrf_conv_int8.argtypes = _build.SIGNATURES["viettts_mrf_conv_int8"]
        libs[name] = lib
    return libs


def variants(dev):
    import torch

    from viettts_tpu_torch.ops import _build
    from viettts_tpu_torch.ops.mrf import quantize_weight_int8

    t0 = time.perf_counter()
    libs = build_variants()
    print(f"built {len(libs)} variants of mrf_int8.cu in {time.perf_counter() - t0:.0f} s", flush=True)
    stream = _build.stream_ptr(dev)
    B = 2
    for C, L in ((256, 1024), (128, 8192), (64, 16384), (32, 32768)):
        x, res = torch.randn(B, L, C, device=dev), torch.randn(B, L, C, device=dev)
        y = torch.empty_like(x)
        for k, d in ((3, 1), (11, 5)):
            q = quantize_weight_int8(torch.randn(k, C, C, device=dev) / (k * C) ** 0.5)
            b, act = torch.randn(C, device=dev) * 0.05, torch.tensor([3.0], device=dev)
            ops = 2.0 * B * L * C * C * k
            cells = []
            for name, lib in libs.items():
                def launch(stream):
                    _build.check(lib.viettts_mrf_conv_int8(
                        0, x.data_ptr(), q.kmajor.data_ptr(), q.scales.data_ptr(), b.data_ptr(), act.data_ptr(),
                        0, 0, res.data_ptr(), y.data_ptr(), None, B, L, C, C, k, d, 0, -1, 1.0, stream),
                        f"variant {name}")
                ms = graph_ms(launch)
                cells.append(f"{name} {1e3 * ms:.1f} us ({ops / ms / 1e9:.0f} TOP/s)")
            print(f"int8 conv B={B} L={L} C={C} k={k} d={d}, in a graph: " + " | ".join(cells), flush=True)
    lib = next(iter(libs.values()))
    x, res = torch.randn(1, 16, 32, device=dev), torch.randn(1, 16, 32, device=dev)
    y = torch.empty_like(x)
    q = quantize_weight_int8(torch.randn(3, 32, 32, device=dev))
    b, act = torch.zeros(32, device=dev), torch.tensor([3.0], device=dev)
    args = (0, x.data_ptr(), q.kmajor.data_ptr(), q.scales.data_ptr(), b.data_ptr(), act.data_ptr(), 0, 0,
            res.data_ptr(), y.data_ptr(), None, 1, 16, 32, 32, 3, 1, 0, -1, 1.0, stream)
    ms = host_ms(lambda: lib.viettts_mrf_conv_int8(*args), reps=200)
    print(f"host: one conv launch through ctypes (pointers given) {1e3 * ms:.1f} us", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_conv_pipeline: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    stages(dev)
    variants(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
