#!/usr/bin/env python3
"""Time of the AR decode kernel (K1, ``ops.ar_decoder.ar_decode``) on one
CUDA GPU at several decoder widths and batches, for comparing plans and
checkouts of the port.

    python3 scripts/time_ar_decode.py [--widths 512,768,1024] [--batches 1,4,16,64]
        [--frames 512] [--sms 132,114] [--reps 3] [--save out.pt] [--compare other.pt]
        [--alt UNITS:GROUPS:STAGE:STREAMED,...]

For each width H (P = 256, D = 80), batch B and SM count (0: the card's
own), seeded inputs as ``chip_smoke.py``'s K1 check draws them (dropout
masks on), then: the plan (``plan_decode``: CTAs, units, groups, staged
rows, streamed gate blocks, shared memory, streamed bytes a frame), the
kernel against its plain twin (max abs error; ``--no-twin`` skips it),
two launches bitwise equal, the CUDA-event time of one launch (the mean
over ``--reps`` after one warm-up), and the roofline bound
(``utils.flops.ar_decode_bound``).  Prints the card's name and power
limit, a line per case, then one JSON line.

``--alt`` also runs each case under other plans than ``plan_decode``'s,
on the same inputs, in turns with it (planned, each alternative, planned
again): hidden units a CTA, column groups, staged rows and the streamed
gate blocks as a bit mask (``ops.ar_decoder.GATE_BLOCKS`` order); the grid
follows from the units.  Each is held to the twin and timed like the plan.

``--save`` writes every case's output to a file and ``--compare`` holds
this run's outputs bitwise to such a file (from another checkout: put it
first on ``PYTHONPATH``, as ``scripts/time_vocoder_stages.py`` does).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def _forced_plan(ar_decoder, H, P, D, rows, units, groups, stage, streamed):
    """A plan of ``units`` hidden units a CTA in ``groups`` column groups,
    ``stage`` staged rows and the gate blocks of ``streamed`` streamed,
    with the grid and shared memory that follow; raises if it does not fit."""
    ctas = -(-H // units)
    pk, dk = ar_decoder._pow2(-(-P // ctas)), ar_decoder._pow2(-(-D // ctas))
    smem = 4 * ar_decoder.smem_floats(H, P, D, units // groups, groups, pk, dk, stage, rows, streamed)
    if smem > ar_decoder.SMEM_LIMIT or units % groups or units // groups > ar_decoder.MAX_UNITS:
        raise ValueError(f"plan {units}:{groups}:{stage}:{streamed} does not fit ({smem} bytes)")
    return ar_decoder.DecodePlan(ctas, units, pk, dk, stage, rows, smem, groups, streamed)


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--widths", default="512,768,1024")
    parser.add_argument("--batches", default="1,4,16,64")
    parser.add_argument("--frames", type=int, default=512)
    parser.add_argument("--sms", default="0", help="SM counts to plan for, comma-separated; 0: the card's")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--no-twin", action="store_true")
    parser.add_argument("--save", type=Path)
    parser.add_argument("--compare", type=Path)
    parser.add_argument("--alt", default="", help="other plans to time: UNITS:GROUPS:STAGE:STREAMED, comma-separated")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_ar_decode: no CUDA device", file=sys.stderr)
        return 1
    sys.path.append(str(REPO))  # after PYTHONPATH: another checkout's package goes first
    from chip_smoke import seeded, time_ms
    from viettts_tpu_torch.ops import ar_decoder
    from viettts_tpu_torch.utils.flops import ar_decode_bound, device_peaks

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    own_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P, D, L = 256, 80, args.frames
    want = torch.load(args.compare) if args.compare else None
    saved, results = {}, []
    for H in _ints(args.widths):
        rng = np.random.default_rng(H)
        weights = [
            seeded(rng, D, P, scale=D ** -0.5), seeded(rng, P, P, scale=P ** -0.5),
            seeded(rng, P + H, 4 * H, scale=(P + H) ** -0.5),
            seeded(rng, P + 2 * H, 4 * H, scale=(P + 2 * H) ** -0.5),
            seeded(rng, 2 * H, D, scale=(2 * H) ** -0.5), seeded(rng, D, scale=0.1),
        ]
        weights = [torch.from_numpy(w).to(dev) for w in weights]
        for B in _ints(args.batches):
            g1c, g2c = (torch.from_numpy(seeded(rng, B, L, 4 * H, scale=0.5)).to(dev) for _ in range(2))
            keep1, keep2 = (torch.from_numpy(rng.random((L, B, P)) < 0.5).to(dev) for _ in range(2))
            call = (g1c, g2c, keep1, keep2, *weights, 2.0)
            for sms in _ints(args.sms):
                sms = sms or own_sms
                plan = ar_decoder.plan_decode(H, P, D, sms, min(B, ar_decoder.MAX_ROWS))
                streamed = getattr(plan, "streamed", 0)
                per_frame = plan.streamed_bytes_per_frame(P, H) if streamed else 0
                got = ar_decoder.ar_decode(*call, num_sms=sms)
                again = ar_decoder.ar_decode(*call, num_sms=sms)
                torch.cuda.synchronize()
                err = None
                if not args.no_twin:
                    err = (got - ar_decoder.ar_decode_plain(*call)).abs().max().item()
                key = f"H{H}_B{B}_L{L}_sms{sms}"
                saved[key] = got.cpu()
                same_as = None
                if want is not None and key in want:
                    same_as = bool(torch.equal(saved[key], want[key]))
                ms = time_ms(lambda: ar_decoder.ar_decode(*call, num_sms=sms), reps=args.reps)
                bound_ms, bound_by = ar_decode_bound(B, L, H, P, D, device_peaks())
                row = {"H": H, "B": B, "L": L, "sms": sms, "ctas": plan.ctas, "units": plan.units,
                       "groups": getattr(plan, "groups", 1), "stage": plan.stage, "streamed": streamed,
                       "streamed_blocks": [n for i, n in enumerate(getattr(ar_decoder, "GATE_BLOCKS", ()))
                                           if streamed >> i & 1],
                       "smem_bytes": plan.smem_bytes, "streamed_bytes_per_frame": per_frame,
                       "max_abs_err": err, "bitwise_run_to_run": bool(torch.equal(got, again)),
                       "bitwise_as_compared": same_as, "ms": ms, "us_per_frame": 1e3 * ms / L,
                       "bound_ms": bound_ms, "bound_by": bound_by}
                for spec in filter(None, args.alt.split(",")):
                    alt = _forced_plan(ar_decoder, H, P, D, min(B, ar_decoder.MAX_ROWS), *_ints(spec.replace(":", ",")))
                    planned = ar_decoder.plan_decode
                    ar_decoder.plan_decode = lambda *_, **__: alt
                    try:
                        alt_out = ar_decoder.ar_decode(*call)
                        alt_err = None if args.no_twin else (
                            alt_out - ar_decoder.ar_decode_plain(*call)).abs().max().item()
                        alt_ms = time_ms(lambda: ar_decoder.ar_decode(*call), reps=args.reps)
                    finally:
                        ar_decoder.plan_decode = planned
                    again_ms = time_ms(lambda: ar_decoder.ar_decode(*call, num_sms=sms), reps=args.reps)
                    row.setdefault("alternatives", []).append(
                        {"spec": spec, "ctas": alt.ctas, "smem_bytes": alt.smem_bytes,
                         "streamed_bytes_per_frame": alt.streamed_bytes_per_frame(P, H), "max_abs_err": alt_err,
                         "ms": alt_ms, "planned_ms_again": again_ms})
                    print(f"  alternative {spec} ({alt.ctas} CTAs, {alt.smem_bytes} B, "
                          f"{alt.streamed_bytes_per_frame(P, H) / 1e6:.1f} MB a frame): {alt_ms:.3f} ms, twin err "
                          f"{alt_err}; the plan again {again_ms:.3f} ms", flush=True)
                    if alt_err is not None and not alt_err <= 1e-4:
                        row["max_abs_err"] = max(row["max_abs_err"], alt_err)
                results.append(row)
                print(f"H={H} B={B} L={L} sms={sms}: {plan.ctas} CTAs x {plan.units} units "
                      f"({row['groups']} groups), stage {plan.stage}, streamed {row['streamed_blocks']} "
                      f"({per_frame / 1e6:.1f} MB a frame); {ms:.3f} ms ({row['us_per_frame']:.2f} us/frame), "
                      f"bound {bound_ms:.4f} ({bound_by}); twin err {err}; run to run {row['bitwise_run_to_run']}; "
                      f"as compared {same_as}", flush=True)
    if args.save:
        args.save.parent.mkdir(parents=True, exist_ok=True)
        torch.save(saved, args.save)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0), "cases": results}))
    bad = [r for r in results if not r["bitwise_run_to_run"] or r["bitwise_as_compared"] is False
           or (r["max_abs_err"] is not None and not r["max_abs_err"] <= 1e-4)]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
