"""A cell as ``BENCHMARK.json`` names it: its configuration file, its
traffic file, its limits file, the model modules its configuration names
and the metrics it reports, each found by name.  A later cell, traffic mix,
metric, kernel name or configuration (a new size of a model the harness
has, or a new architecture with its model module) is a new file and a new
entry, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
DEFAULT_MODELS = {"duration": "viettts_duration", "acoustic": "viettts_acoustic", "vocoder": "hifigan"}


class Models(NamedTuple):
    """A configuration's model modules (``perfbench/reference/models/``)."""

    duration: ModuleType
    acoustic: ModuleType
    vocoder: ModuleType


def load_module(path: Path, prefix: str) -> ModuleType:
    """The Python file ``path``, imported as ``<prefix><its stem>``."""
    spec = importlib.util.spec_from_file_location(prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_models(config: dict, bench_dir: Path = BENCH_DIR) -> Models:
    """The modules ``reference/models/<name>.py`` of the configuration's
    ``models`` section; a role it leaves out takes its default."""
    names = config.get("models", {})
    unknown = set(names) - set(Models._fields)
    if unknown:
        raise KeyError(f"models: no role {sorted(unknown)} (roles: {', '.join(Models._fields)})")
    d = bench_dir / "reference" / "models"
    paths = {role: d / f"{names.get(role, DEFAULT_MODELS[role])}.py" for role in Models._fields}
    for role, path in paths.items():
        if not path.is_file():
            raise FileNotFoundError(f"no {role} model module {path.name} under {d}")
    return Models(**{role: load_module(path, "perfbench_model_") for role, path in paths.items()})


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # perfbench/traffic/<traffic>.json
    limits: dict  # perfbench/limits/<cell>.json
    models: Models
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
    bench_dir = root / BENCH_DIR.name
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        models=load_models(config, bench_dir),
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

