#!/usr/bin/env python3
"""Time of the four default generator stages (``fused_mrf``, kernels K2 and
K3) on one CUDA GPU, for comparing two checkouts of the port.

    python3 scripts/time_vocoder_stages.py [--reps 20] [--batch 2] [--frames 128] [--routes ...] [--pipelines]

B=2 at 128 mel frames (``--batch``, ``--frames``), ResBlock1,
``chip_smoke.py``'s seeded stage weights: per route (bfloat16, float32,
int8 with static and with dynamic scales; ``--routes`` picks some) the
CUDA-event time of the four stages called back to back, the mean over
``--reps`` calls after one warm-up (host enqueue included, as the pipeline
pays it), the host time to enqueue them, and each stage's time alone; for
dynamic int8, where the package runs it on the TPU kernel's tile windows,
each stage's windows a row and the time that copies of them would take
alone (the twin's way, ``mrf.by_windows``; the wgmma pipeline runs every
window at once without them).
``--digests FILE`` writes each stage output's SHA-256, and that of the
whole generator (``generator_apply_fused`` on ``chip_smoke.py``'s seeded
weights, at the same batch and frames, each route: the stages' rungs on
the int8 route printed), or, where FILE exists, says which outputs are bit
for bit the saved ones (another checkout's).  Prints the card's name and
power limit, then one JSON line.

``--pipelines`` times instead, for each route, the MRF convs alone of each
stage on the pipeline that takes it (or would: ``--routes``) and on the
per-conv ``mma_conv_kernel`` one, in turns in one process (per-conv, new,
new, per-conv): on the bf16 and static int8 routes the stages of
``mrf.FUSED_CHANNELS`` on the fused pipeline (the per-conv runs with
``FUSED_CHANNELS`` emptied) and the C = 256 and 128 stages on the per-conv
wgmma pipeline; on the float32 route (3xTF32) and dynamic int8 every
stage on the wgmma pipeline, whatever its router says (``mrf.CONV_WGMMA =
"any"``; the per-conv runs with it off).  It checks that the two agree
(bitwise on int8) and prints beside them the stage's 18 convs as cuDNN
conv1d calls (bf16; float32 with TF32 off), the stage's roofline bound
(``utils.flops.mrf_stage_bound``) and whether the router takes the stage.

``viettts_tpu_torch`` is imported from ``sys.path``: put another checkout
first on ``PYTHONPATH`` to time it, and run two checkouts in turns in one
session to compare them on one card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--frames", type=int, default=128)
    parser.add_argument("--pipelines", action="store_true", help="fused or wgmma against per-conv MRF convs")
    parser.add_argument("--digests", help="a JSON file of each stage output's SHA-256: written where absent, "
                                          "else compared (two checkouts' outputs, bit for bit)")
    parser.add_argument("--routes", default="bfloat16,int8,float32,int8_dynamic",
                        help="the routes to time, comma-separated")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_vocoder_stages: no CUDA device", file=sys.stderr)
        return 1
    sys.path.append(str(REPO))  # chip_smoke.py, after any checkout on PYTHONPATH
    import chip_smoke
    import viettts_tpu_torch
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.ops import mrf
    from viettts_tpu_torch.ops.mrf import fused_mrf, mrf_walk, prepare_mrf_weights
    from viettts_tpu_torch.utils.flops import stage_shapes

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg, dev, bf16 = Config().hifigan, torch.device("cuda"), torch.bfloat16
    ks, ds = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes
    rng = np.random.default_rng(7)
    if args.pipelines:
        return pipelines(args, smi, cfg, dev, rng)
    calls = {"bfloat16": [], "float32": [], "int8": [], "int8_dynamic": []}
    for C_in, C, k_u, u, L_in, post in stage_shapes(cfg, args.frames):
        x = torch.from_numpy(chip_smoke.seeded(rng, args.batch, L_in, C_in)).to(dev)
        xb = x.to(bf16)
        for route, dtype, inp in (("bfloat16", bf16, xb), ("float32", torch.float32, x)):
            w, ups, pst = chip_smoke.stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, False, dtype)
            calls[route].append((inp, w, dict(upsample=ups, post=pst, compute_dtype=dtype)))
        # the int8 route as chip_smoke.py's K3 check builds it
        w32, ups32, pst32 = chip_smoke.stage_weights(rng, dev, cfg, C_in, C, k_u, u, post, False, torch.float32)
        _, amax = mrf_walk(xb.float().transpose(1, 2), w32, ks, ds, lambda j, y: y.abs().amax(), upsample=ups32)
        w, ups, pst = prepare_mrf_weights(w32, ups32, pst32, bf16, quantize_int8=True)
        for route, act in (("int8", torch.stack(amax)), ("int8_dynamic", None)):
            kw = dict(upsample=ups, post=pst, compute_dtype=bf16, quantize_int8=True, act_scales=act)
            calls[route].append((xb, w, kw))

    result = {"package": str(Path(viettts_tpu_torch.__file__).parent), "card": smi, "batch": args.batch,
              "frames": args.frames}
    wanted = args.routes.split(",")
    for route, stages in calls.items():
        if route not in wanted:
            continue
        def run():
            for inp, w, kw in stages:
                fused_mrf(inp, w, ks, ds, **kw)

        ms = chip_smoke.time_ms(run, reps=args.reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        stages_ms = [chip_smoke.time_ms(lambda: fused_mrf(inp, w, ks, ds, **kw), reps=args.reps)
                     for inp, w, kw in stages]
        result[route] = {"ms": ms, "enqueue_ms": enqueue_ms, "stages_ms": stages_ms}
        print(f"{route}: 4 stages {ms:.3f} ms (host enqueue {enqueue_ms:.3f} ms), alone "
              f"{', '.join(f'{t:.3f}' for t in stages_ms)} ms", flush=True)
        if route == "int8_dynamic" and hasattr(mrf, "dynamic_windows"):
            result[route].update(window_copies(args, stages, ks, ds, stages_ms))
        if args.digests:
            result[route]["sha256"] = [digest(fused_mrf(inp, w, ks, ds, **kw)) for inp, w, kw in stages]
    if args.digests:
        for route, d in generator_digests(args, wanted, dev, rng).items():
            result[route]["sha256"].append(d)  # after the 4 stages' digests
        path = Path(args.digests)
        if path.exists():
            saved = json.loads(path.read_text())
            same = {route: [a == b for a, b in zip(saved[route], result[route]["sha256"])]
                    for route in wanted if route in saved and route in result}
            result["same_bits_as_saved"] = same
            print(f"the 4 stage outputs, then the generator's, bit for bit those of {saved['package']}: {same}",
                  flush=True)
        else:
            path.write_text(json.dumps({"package": result["package"],
                                        **{r: result[r]["sha256"] for r in wanted if r in result}}))
    print(json.dumps(result), flush=True)
    return 0


def digest(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(t.cpu().flatten().view(torch.uint8).numpy().tobytes()).hexdigest()


def generator_digests(args, routes, dev, rng) -> dict:
    """SHA-256 of ``generator_apply_fused``'s waveform on each route, at
    ``--batch`` and ``--frames``, on ``chip_smoke.py``'s seeded generator
    weights and a seeded mel; int8 static calibrated on that mel."""
    import torch

    import chip_smoke
    from viettts_tpu_torch.checkpoint import load_generator
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.models import hifigan

    cfg = Config()
    gen = hifigan.Generator(cfg.hifigan).eval()
    load_generator(gen, chip_smoke.seeded_variables(cfg)["hifigan"])
    gen = gen.to(dev)
    mel = torch.from_numpy(chip_smoke.seeded(rng, args.batch, args.frames, cfg.hifigan.mel_dim)).to(dev)
    h = cfg.hifigan
    rungs = hifigan.int8_rungs(gen.fused_weights(torch.bfloat16, quantize_int8=True), args.frames, torch.bfloat16,
                               h.resblock_kernel_sizes, h.resblock_dilation_sizes)
    print(f"generator at B={args.batch} x {args.frames} frames: int8 rungs {rungs}", flush=True)
    out = {}
    with torch.no_grad():
        calls = {"bfloat16": lambda: hifigan.generator_apply_fused(gen, mel, torch.bfloat16),
                 "float32": lambda: hifigan.generator_apply_fused(gen, mel),
                 "int8": lambda: hifigan.generator_apply_fused(
                     gen, mel, torch.bfloat16, quantize_int8=True,
                     act_scales=hifigan.generator_calibrate_int8(gen, mel)),
                 "int8_dynamic": lambda: hifigan.generator_apply_fused(gen, mel, torch.bfloat16, quantize_int8=True)}
        for route in routes:
            out[route] = digest(calls[route]())
    return out


def window_copies(args, stages, ks, ds, stages_ms) -> dict:
    """The layout copies that running a dynamic int8 stage's tile windows on
    copies would take (``mrf.by_windows``: ``gather_windows`` of the
    float32 trunk and ``scatter_centres`` of the output, for each length of
    window; the card's wgmma pipeline runs every window at once and makes
    none), timed alone per stage beside the stage's time."""
    import torch

    import chip_smoke
    from viettts_tpu_torch.ops import mrf

    out = {"tiles": [], "copies_ms": []}
    for (inp, w, kw), stage_ms in zip(stages, stages_ms):
        run = mrf.dynamic_windows(inp, w, ks, ds, kw["upsample"], kw["post"], torch.bfloat16)
        if run is None:
            out["tiles"].append(1)
            out["copies_ms"].append(0.0)
            continue
        B, L = inp.shape[0], inp.shape[1] * kw["upsample"][2]
        C = mrf._dense(kw["upsample"][0]).shape[2]
        c_out, dtype = (1, torch.float32) if kw["post"] is not None else (C, torch.bfloat16)
        h = torch.zeros(B, L, C, device=inp.device)
        dst = torch.empty(B, L, c_out, dtype=dtype, device=inp.device)
        groups = mrf.tile_windows(run.seq, run.tile, run.halo)
        ys = [torch.zeros(B * len(items), n, c_out, dtype=dtype, device=inp.device) for n, items in groups]

        def copies():
            for (n, items), y in zip(groups, ys):
                mrf.gather_windows(h, items, n)
                mrf.scatter_centres(y, items, run.tile, dst)

        ms = chip_smoke.time_ms(copies, reps=args.reps)
        out["tiles"].append(run.n)
        out["copies_ms"].append(ms)
        print(f"  C={C}: {out['tiles'][-1]} tile windows a row; copies of them would take {ms:.3f} ms beside the "
              f"stage's {stage_ms:.3f} ({100 * ms / stage_ms:.1f}%)", flush=True)
        del h, dst, ys
    return out


def pipelines(args, smi, cfg, dev, rng) -> int:
    """``--pipelines``: per stage and route, the MRF convs on the per-conv
    pipeline and on the one that takes the stage, in turns."""
    import torch

    import chip_smoke
    from viettts_tpu_torch.ops import mrf
    from viettts_tpu_torch.utils.flops import device_peaks, mrf_stage_bound, stage_shapes

    ks, ds, bf16 = cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes, torch.bfloat16
    fused_channels = mrf.FUSED_CHANNELS
    peaks = device_peaks()
    wanted = args.routes.split(",")
    rows = []
    for C_in, C, k_u, u, L_in, post in stage_shapes(cfg, args.frames):
        L = L_in * u
        w32, _, _ = chip_smoke.stage_weights(rng, dev, cfg, C_in, C, k_u, u, False, False, torch.float32)
        h32 = torch.from_numpy(chip_smoke.seeded(rng, args.batch, L, C)).to(dev)
        h = h32.to(bf16)
        _, amax = mrf.mrf_walk(h.float().transpose(1, 2), w32, ks, ds, lambda j, y: y.abs().amax())
        w8 = mrf.prepare_mrf_weights(w32, quantize_int8=True)[0]
        routes = {"bfloat16": (h, mrf.prepare_mrf_weights(w32, compute_dtype=bf16)[0], dict(compute_dtype=bf16)),
                  "int8": (h, w8, dict(compute_dtype=bf16, quantize_int8=True, act_scales=torch.stack(amax))),
                  "float32": (h32, mrf.prepare_mrf_weights(w32)[0], {}),
                  "int8_dynamic": (h, w8, dict(compute_dtype=bf16, quantize_int8=True))}
        for route in wanted:
            x, w, kw = routes[route]
            conv_route = mrf.conv_route_name(route.removesuffix("_dynamic"), route == "int8")
            if route in ("bfloat16", "int8"):
                if C not in fused_channels and not mrf.conv_takes(conv_route, args.batch, L, C):
                    continue
                new = "fused" if C in fused_channels else "wgmma"
            else:
                new = "wgmma"
            ms, outs = {"per_conv": [], new: []}, {}
            for name in ("per_conv", new, new, "per_conv"):
                mrf.FUSED_CHANNELS = fused_channels if name == "fused" else ()
                mrf.CONV_WGMMA = {"per_conv": False, "fused": True, "wgmma": "any"}[name]
                ms[name].append(chip_smoke.time_ms(lambda: mrf.fused_mrf(x, w, ks, ds, **kw), reps=args.reps))
                outs[name] = mrf.fused_mrf(x, w, ks, ds, **kw).float()
            mrf.FUSED_CHANNELS, mrf.CONV_WGMMA = fused_channels, True
            diff = (outs[new] - outs["per_conv"]).abs().max().item()
            if route.startswith("int8") and diff != 0.0:
                print(f"C={C} {route}: the pipelines differ by {diff}", file=sys.stderr)
                return 1
            bound = mrf_stage_bound(cfg, args.batch, L, C, "int8" if route.startswith("int8") else route, peaks)
            lib_ms = (chip_smoke.cudnn_mrf_ms(cfg, x.transpose(1, 2).contiguous(), w, args.reps)
                      if route in ("bfloat16", "float32") else None)
            routed = new == "fused" or mrf.conv_takes(conv_route, args.batch, L, C)
            rows.append({"C": C, "L": L, "route": route, "pipeline": new, "per_conv": ms["per_conv"],
                         "new": ms[new], "max_abs_diff": diff, "cudnn_ms": lib_ms, "bound_ms": bound[0],
                         "bound_by": bound[1], "routed": routed})
            print(f"C={C} {route}: per-conv {ms['per_conv'][0]:.3f}; {ms['per_conv'][1]:.3f} ms, {new} "
                  f"{ms[new][0]:.3f}; {ms[new][1]:.3f} ms ({new} / per-conv "
                  f"{sum(ms[new]) / sum(ms['per_conv']):.3f}), max |{new} - per-conv| {diff:.3e}; cuDNN "
                  f"{'-' if lib_ms is None else f'{lib_ms:.3f}'} ms; bound {bound[0]:.3f} ms ({bound[1]}); "
                  f"router {'takes' if routed else 'leaves'} it", flush=True)
            del outs
        del h, h32, routes
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "batch": args.batch, "frames": args.frames, "pipelines": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
