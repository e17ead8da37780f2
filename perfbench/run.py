#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell's configuration on seeded weights, warms it up, drives the
program (``viettts_tpu_torch``) with the cell's traffic for ``--seconds``,
checks a sample of what it returned against the plain reference, and prints
one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics from a device trace), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks`` (each number compared,
with its limit), which also end standard error, after a ``run:`` line (the
window's length, its calls and the rows compared).  Runs only on a CUDA card:
without one, or with fewer cards than the cell asks for, it exits with 2 and
prints no result; it also exits non-zero without a result when JAX, flax or
the JAX package is loaded in this process once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench.harness import cells
    from perfbench.harness.core import loaded_forbidden, run_cell

    cell = cells.load(args.workload)
    import viettts_tpu_torch  # the system under test: the checkout's own, never an installed copy

    if ROOT not in Path(viettts_tpu_torch.__file__).resolve().parents:
        print(f"perfbench: viettts_tpu_torch comes from {viettts_tpu_torch.__file__}, not this checkout",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card; the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the process holds {', '.join(found)} after the window; no result", file=sys.stderr)
        return 3
    print(f"run: {json.dumps(result.pop('run'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
