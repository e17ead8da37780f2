#!/usr/bin/env python3
"""The readings that the limits of ``perfbench/limits/<cell>.json`` are set
from: the numbers compared, on many seeds, for the program as the cell runs
it and for the lower-precision controls, each seed in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--int8]

Per seed it prints one JSON line: ``program`` (the cell's own run: the lower
reading), ``bfloat16`` (the reference at bfloat16 autocast put in the
program's place for every stage: the control of the float32 durations and
decode), ``float8`` (the reference vocoder in e4m3 in the program's place
on the served log-mel), and with ``--int8`` a second run of the seed on
the program's own int8 vocoder route (the waveform's control), the
reference keeping the stated bfloat16.  The benchmark's runs never run
this.  Needs a card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--int8", action="store_true", help="also run each seed on the program's int8 vocoder route")
    args = p.parse_args(argv)

    import torch

    from perfbench.harness import cells
    from perfbench.harness.core import run_cell

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(cell, seed, args.seconds, False, device, time.perf_counter(), also=("bfloat16", "float8"))
        line = {"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()},
                "bfloat16": res["also"]["bfloat16"], "float8": res["also"]["float8"], "run": res["run"],
                "metrics": res["metrics"]}
        if args.int8:
            r8 = run_cell(cell, seed, args.seconds, False, device, time.perf_counter(), program_route="int8")
            line["int8"] = {k: v["value"] for k, v in r8["checks"].items()}
            line["int8"]["wave_gap_worst_row"] = r8["run"]["wave_gap_worst_row"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
