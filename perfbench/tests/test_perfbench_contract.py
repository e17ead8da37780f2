"""``BENCHMARK.json`` is well formed, every cell finds its files, and
nothing the benchmark runs imports JAX or the JAX package (top-level module
names compared whole); the reference imports nothing of the program."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"] and SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check with 24 cells fits 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == keys, (group, e["name"])
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        for c in m["workloads"]:  # each listed cell reports the metric it moves
            assert "workloads" not in e2e[m["moves"]] or c in e2e[m["moves"]]["workloads"]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline_pct.bulk") or m["name"].endswith("_roofline")
    for c in cells:  # setup_s, another end-to-end metric and a per-layer one in every cell
        assert sum(c in m.get("workloads", cells) for m in SPEC["end_to_end"]) >= 2
        assert any(c in m["workloads"] for m in SPEC["per_layer"])
    assert len({m["layer"] for m in SPEC["per_layer"]}) >= 4


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    from perfbench.harness import cells

    c = cells.load(cell)
    assert c.chips == 1 and c.traffic["driver"] in ("closed_batch", "closed_stream")
    assert set(c.limits) == {"dur_gap", "mel_gap", "wave_gap", "length_gap", "missing"}
    assert c.limits["length_gap"] == 0 and c.limits["missing"] == 0
    cfg = next(x for x in SPEC["configs"] if x["name"] == next(w["config"] for w in SPEC["workloads"]
                                                               if w["name"] == cell))
    assert c.config["reduced"] == cfg["reduced"] and c.config["source"] == cfg["source"]
    from perfbench.harness.program import program_config

    program_config(c.config["sizes"])  # the program runs every size the file states


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_and_a_reference_free_of_the_program():
    sources = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert sources
    for p in sources:
        tops = {m.split(".")[0] for m in _imports(p)}
        assert not tops & {"jax", "jaxlib", "flax", "viettts_tpu"}, p
    for p in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(p)}
        assert "viettts_tpu_torch" not in tops, p


def test_the_guard_compares_whole_names():
    import sys

    from perfbench.harness.core import loaded_forbidden

    import viettts_tpu_torch  # noqa: F401 — begins with the JAX package's name, and is allowed

    assert "viettts_tpu_torch" not in loaded_forbidden()
    sys.modules["viettts_tpu.fake"] = sys
    try:
        assert loaded_forbidden() == ["viettts_tpu"]
    finally:
        del sys.modules["viettts_tpu.fake"]
