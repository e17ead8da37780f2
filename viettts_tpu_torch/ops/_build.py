"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, which is loaded with ``ctypes``.  The build runs at first use
(never at import: the CPU tests import every module) and again whenever
the sources change: the library's file name carries a hash of the sources
and flags.  Output goes to ``viettts_tpu_torch/_build/``, which git
ignores.

Every C entry point takes raw pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` right after its launches; ``check``
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signatures of the entry points in csrc/ (all return a cudaError_t as int)
SIGNATURES = {
    # g1c, g2c, keep1, keep2, w_fc1, w_fc2, w1m, w2m, wp, bp, out,
    # B, L, H, P, D, scale, stream
    "viettts_ar_decode": [P] * 11 + [I] * 5 + [F, P],
    # bf16, x, w, bias, y, B, L_in, C_in, C_out, k, u, pad_a, stream
    "viettts_mrf_convt": [I, P, P, P, P] + [I] * 7 + [P],
    # w_bf16, out_bf16, x, w, bias, res, y, out,
    # B, L, C_in, C_out, k, dilation, mode, scale, stream
    "viettts_mrf_conv": [I, I] + [P] * 6 + [I] * 7 + [F, P],
    # w_bf16, x, w, bias, out, B, L, C, C_post, k, stream
    "viettts_mrf_post": [I, P, P, P, P] + [I] * 5 + [P],
    # x_bf16, y_f32, n, stream
    "viettts_mrf_to_f32": [P, P, ctypes.c_longlong, P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libviettts_kernels_{h.hexdigest()[:16]}.so"


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cu, _ = _sources()
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        tmp.replace(so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.viettts_error_string.argtypes = [I]
    lib.viettts_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        name = _lib.viettts_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
