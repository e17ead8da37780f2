"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together) and links the objects into one shared library with a plain C
interface, which is loaded with ``ctypes``.  The build runs at first use
(never at import: the CPU tests import every module) and again whenever
the sources change: the library's file name carries a hash of the sources
and flags.  Output goes to ``viettts_tpu_torch/_build/``, which git
ignores.

Every C entry point takes raw pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` right after its launches; ``check``
turns a non-zero code into an exception.

``load_plan_library`` builds ``csrc/mrf_conv_plan.cpp`` with the system's
C++ compiler (no CUDA: it runs on the CPU too) into a small library with
the per-conv wgmma pipeline's plan, the same header the kernel library
plans its launches with.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from viettts_tpu_torch.utils.profiling import always_span

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong
# C signatures of the extern "C" entry points in csrc/ (tests/test_torch_build.py
# holds the two in step); all return a cudaError_t as int but those in RESTYPES
SIGNATURES = {
    # g1c, g2c, keep1, keep2, w_fc1, w_fc2, w1m, w2m, wp, bp, out, exchange, wstream, B, L, H, P, D,
    # ctas, group_units, groups, prenet_cols, proj_cols, stage, rows, streamed, smem_bytes, scale, stream
    "viettts_ar_decode": [P] * 13 + [I] * 14 + [F, P],
    # H, P, D, ctas, group_units, groups, prenet_cols, proj_cols, stage, rows, streamed, smem_bytes
    "viettts_ar_decode_prepare": [I] * 12,
    # w_bf16, x, w (bf16, or float32 TF32 hi/lo), bias, y,
    # B, L_in, C_in, C_out, k, u, pad_a, tile (-1: by shape), stream
    "viettts_mrf_convt_mma": [I, P, P, P, P] + [I] * 8 + [P],
    # w_bf16, out_bf16, x, w (bf16, or float32 TF32 hi/lo), bias, res, y, out,
    # B, L, C_in, C_out, k, dilation, mode, tile (-1: by shape), div, stream
    "viettts_mrf_conv": [I, I] + [P] * 6 + [I] * 8 + [F, P],
    # w_bf16, out_bf16, B, L, C, div, n, plan (n rows of PLAN_FIELDS int64), stream
    "viettts_mrf_conv_plan": [I] * 5 + [F, I, P, P],
    # out_bf16, B, L, C, n_res, win, bm, stages, ctas, x, res (n_res rows of
    # FUSED_RES_FIELDS int64), out, stream
    "viettts_mrf_fused": [I] * 9 + [P] * 4,
    # out_bf16, B, L, C, n_res, win, bm, stages, ctas, x, res, act, out, stream
    "viettts_mrf_fused_int8": [I] * 9 + [P] * 5,
    # w_bf16, x, w, bias, out, B, L, C, C_post, k, stream
    "viettts_mrf_post": [I, P, P, P, P] + [I] * 5 + [P],
    # x_bf16, y_f32, n, stream
    "viettts_mrf_to_f32": [P, P, LL, P],
    # H, ctas, slices, groups, group_rows, smem_bytes
    "viettts_bilstm_prepare": [I] * 6,
    # xp_f, xp_b, wh_f, wh_b, lengths, out, exchange, B, T, H, ctas, slices, groups, group_rows, smem_bytes, stream
    "viettts_bilstm": [P] * 7 + [I] * 8 + [P],
    # code -> its name
    "viettts_error_string": [I],
    # out_bf16, x, w (int8 [k, C_out, C_in]), scale, bias, act, act_stride, dynamic,
    # res, y, out, B, L, C_in, C_out, k, dilation, mode, tile (-1: by shape), div, stream
    "viettts_mrf_conv_int8": [I] + [P] * 5 + [I, I] + [P] * 3 + [I] * 8 + [F, P],
    # x, w (float64 [k, C_out, C_in]), bias, y, B, L_in, C_in, C_out, k, u, pad_a,
    # tile (-1: by shape), stream
    "viettts_mrf_convt_f64": [P] * 4 + [I] * 8 + [P],
    # out_bf16, B, L, C, div, n, plan (n rows of PLAN_FIELDS int64), stream
    "viettts_mrf_conv_int8_plan": [I] * 4 + [F, I, P, P],
    # x, amax, B, n, stream
    "viettts_mrf_absmax": [P, P, I, LL, P],
    # out_bf16, B, L, C, div, n, table (n rows of CONV_FIELDS int64), stream
    "viettts_mrf_conv_wgmma": [I] * 4 + [F, I, P, P],
    "viettts_mrf_conv_wgmma_int8": [I] * 4 + [F, I, P, P],
    "viettts_mrf_conv_wgmma_tf32": [I] * 4 + [F, I, P, P],
    # out_bf16, B, L, C, div, n, table, h (float32 [B, L, C]), h_op (its codes), amax [n_amax, B], n_amax,
    # tile windows (n, B, tile, halo, seq: 0 for none), out_win, stream
    "viettts_mrf_conv_wgmma_int8_dynamic": [I] * 4 + [F, I] + [P] * 4 + [I] * 7 + [P],
    # B, L, C, h, n, rows (n x (out, act) int64), stream
    "viettts_mrf_conv_operands": [I] * 3 + [P, I, P, P],
    "viettts_mrf_conv_operands_int8": [I] * 3 + [P, I, P, P],
    "viettts_mrf_conv_operands_tf32": [I] * 3 + [P, I, P, P],
}
# the plan library (csrc/mrf_conv_plan.cpp)
PLAN_SIGNATURES = {
    # route, B, L, C
    "viettts_conv_wgmma_takes": [I] * 4,
    # route, B, L, C, k, dil, sms, out (CONV_PLAN_FIELDS ints)
    "viettts_conv_wgmma_plan": [I] * 7 + [P],
}
PLAN_SOURCE = CSRC_DIR / "mrf_conv_plan.cpp"
RESTYPES = {"viettts_error_string": ctypes.c_char_p}

_lib: Optional[ctypes.CDLL] = None
_plan_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh")) + sorted(CSRC_DIR.glob("*.h"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libviettts_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process.
    The ``setup.library`` span (attr ``built``) times the build and the
    load."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    with always_span("setup.library", "host", built=not so.exists()):
        if not so.exists():
            _build_library(so)
        lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def _build_library(so: Path) -> None:
    """nvcc every ``csrc/*.cu`` in parallel and link them into ``so``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    cu, _ = _sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(src)] for src, o in zip(cu, objs))
    ]
    tmp = BUILD_DIR / f"{tag}.tmp"
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append((cmd, proc.returncode, out))
    if not failed:
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append((cmd, proc.returncode, proc.stdout + proc.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}" for cmd, rc, out in failed
        ))
    tmp.replace(so)


def load_plan_library() -> ctypes.CDLL:
    """Build (if needed) and load the plan library; cached per process.
    Its file name carries a hash of its sources, as the kernel library's."""
    global _plan_lib
    if _plan_lib is not None:
        return _plan_lib
    sources = [PLAN_SOURCE] + sorted(CSRC_DIR.glob("*.h"))
    h = hashlib.sha256()
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    so = BUILD_DIR / f"libviettts_plan_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.tmp"
        cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler found (c++, g++ or $CXX) to build the plan library")
        cmd = [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(PLAN_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in PLAN_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _plan_lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        name = _lib.viettts_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
