"""A cell as ``BENCHMARK.json`` names it: its configuration file, its
traffic file, its limits file and the metrics it reports, each found by
name.  A later cell, configuration, traffic mix or metric is a new file and
a new entry, never an edit."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # perfbench/traffic/<traffic>.json
    limits: dict  # perfbench/limits/<cell>.json
    end_to_end: List[dict]  # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def kernel_patterns(group: str) -> List[str]:
    """Kernel-name substrings of ``group``: the union of
    ``perfbench/metrics/kernels/<group>.json`` and ``<group>.*.json``, each
    a JSON list, so that a kernel under a new name is a new file."""
    d = BENCH_DIR / "metrics" / "kernels"
    out: List[str] = []
    for path in sorted([d / f"{group}.json"] + sorted(d.glob(f"{group}.*.json"))):
        if path.exists():
            out += json.loads(path.read_text())
    if not out:
        raise FileNotFoundError(f"no kernel patterns for {group!r} under {d}")
    return out

