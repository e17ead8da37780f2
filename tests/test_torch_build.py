"""The ctypes table of the port's kernel library against the CUDA sources,
on the CPU: every ``extern "C"`` entry point in ``viettts_tpu_torch/csrc/*.cu``
has a ``_build.SIGNATURES`` entry with the same argument types, and every
entry names such an entry point.  A stale entry then fails here, and not
only when the library loads on the card (a missing symbol) or, worse, as a
call that ctypes marshals into the wrong argument slots.
"""

import ctypes
import re

import pytest

from viettts_tpu_torch.ops import _build

C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "int*": ctypes.c_void_p, "float": ctypes.c_float,
           "long long": ctypes.c_longlong, "char*": ctypes.c_char_p}
EXTERN_C = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{')


def _c_type(decl: str, named: bool = True) -> str:
    """``const void* x`` -> ``void*``; ``long long n`` -> ``long long``."""
    words = decl.replace("*", " * ").split()
    if named:
        words = words[:-1]
    words = [w for w in words if w != "const"]
    base = " ".join(w for w in words if w != "*")
    return base + "*" if "*" in words else base


def _entry_points():
    """{name: (source file, return type, [argument types])} of csrc/*.cu."""
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for ret, name, params in EXTERN_C.findall(src.read_text()):
            args = [_c_type(p) for p in params.split(",") if p.strip()]
            found[name] = (src.name, _c_type(ret, named=False), args)
    return found


def test_every_extern_c_is_parsed():
    """The pattern above sees every ``extern "C"`` of the sources (a
    definition it missed would escape the mirror test)."""
    n = sum(src.read_text().count('extern "C"') for src in _build.CSRC_DIR.glob("*.cu"))
    assert len(_entry_points()) == n >= 9


@pytest.mark.parametrize("name", sorted(set(_build.SIGNATURES) | set(_entry_points())))
def test_signature_mirrors_the_kernel_source(name):
    sources = _entry_points()
    assert name in sources, f"_build.SIGNATURES names {name}, which no csrc/*.cu defines"
    src, ret, args = sources[name]
    assert name in _build.SIGNATURES, f"csrc/{src} defines {name}, which _build.SIGNATURES lacks"
    assert [C_TYPES[a] for a in args] == _build.SIGNATURES[name], f"{name}: csrc/{src} takes {args}"
    assert C_TYPES[ret] == _build.RESTYPES.get(name, ctypes.c_int), f"{name} returns {ret}"


def test_plan_rows_mirror_the_kernel_source():
    """``ops/mrf.py`` builds a stage's launch plan with as many int64 fields
    a conv as ``plan_conv`` in csrc/mrf_common.cuh reads."""
    from viettts_tpu_torch.ops import mrf

    src = (_build.CSRC_DIR / "mrf_common.cuh").read_text()
    fields = int(re.search(r"constexpr int PLAN_FIELDS = (\d+);", src).group(1))
    assert mrf.PLAN_FIELDS == fields
    assert max(int(i) for i in re.findall(r"\br\[(\d+)\]", src)) == fields - 1


def test_conv_rows_mirror_the_kernel_source():
    """``ops/mrf.py`` builds the per-conv wgmma pipeline's launch table with
    as many int64 fields a conv as ``conv_wgmma_stage`` in
    csrc/mrf_conv_wgmma.cuh reads."""
    from viettts_tpu_torch.ops import mrf

    src = (_build.CSRC_DIR / "mrf_conv_wgmma.cuh").read_text()
    fields = int(re.search(r"constexpr int CONV_FIELDS = (\d+);", src).group(1))
    assert mrf.CONV_FIELDS == fields
    stage = src[src.index("int conv_wgmma_stage("):]
    assert max(int(i) for i in re.findall(r"\br\[(\d+)\]", stage[:stage.index("\n}\n")])) == fields - 1


def test_plan_library_mirrors_its_source():
    """``_build.PLAN_SIGNATURES`` against the ``extern "C"`` entry points of
    csrc/mrf_conv_plan.cpp, which the plan library is built from, and
    ``ops/mrf.py::ConvPlan`` against the fields its plan call writes."""
    from viettts_tpu_torch.ops import mrf

    src = _build.PLAN_SOURCE.read_text()
    found = {name: [C_TYPES[_c_type(p)] for p in params.split(",") if p.strip()]
             for ret, name, params in EXTERN_C.findall(src)}
    assert found == _build.PLAN_SIGNATURES
    header = (_build.CSRC_DIR / "mrf_conv_plan.h").read_text()
    fields = re.search(r"struct ConvPlan \{\s*int ([\w, ]+);", header).group(1).split(", ")
    assert list(mrf.ConvPlan._fields) == fields
    assert int(re.search(r"constexpr int CONV_PLAN_FIELDS = (\d+);", header).group(1)) == len(fields)
