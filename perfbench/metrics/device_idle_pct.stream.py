"""The share of the traced window (%) in which no kernel, copy or memset
ran on the device."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("perfbench_metric_idle", Path(__file__).with_name("_idle.py"))
_idle = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_idle)


def read(ctx):
    return _idle.idle_pct(ctx)
