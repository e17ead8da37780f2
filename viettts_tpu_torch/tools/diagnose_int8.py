"""Root-causes of the int8 vocoder's error on trained weights (counterpart of
``scripts/diagnose_int8.py``).

    python -m viettts_tpu_torch.tools.diagnose_int8 [--ckpt CKPT] [--margin 1.25] \\
        [--out runs/diagnose_int8] [--device cuda] [--set K=V ...]

A fake-quantized walk of the generator in plain torch (``generator_walk``:
the MRF convs in K3's flat order and scheme, per-output-channel int8
weights and one activation scale a conv; conv_pre, the ConvTranspose
prologues and conv_post stay float32, K3's quantization boundary) isolates
each factor of the error against the unquantized walk, on the held-out
probe clip with calibration on the first corpus clip:

* full simulation (weights and per-conv static activation scales, the
  calibrated amax times ``--margin``): what K3 should measure;
* weights only, activations only;
* per-channel activation scales (finer than K3 supports);
* 99.9th-percentile activation clipping (an outlier-robust scale);
* each MRF conv input's crest factor (amax / rms) on the trained weights
  and on the GAN trainer's random initial weights.

It also runs the static int8 serving route (``generator_apply_fused``: K3
on the card, its plain twin on the CPU) with the same scales against the
plain float32 generator on the same clip, and reports the gap to the full
simulation.  The route also stores bf16 between stages, so the gap is
judged against the bf16 route's own error: a gap beyond
``0.25 * simulation + bf16 error + 1e-3`` is reported as a kernel fault.

The walk's last leaky_relu has the generator's slope, 0.01; the JAX
script's has 0.1, which is not the generator it simulates.
Results -> ``--out``/``int8_diagnosis.json``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from viettts_tpu_torch.audio import read_wav
from viettts_tpu_torch.config import Config, apply_overrides
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.ops.mrf import LRELU_SLOPE, POST_LRELU_SLOPE, conv_transpose_same
from viettts_tpu_torch.tools.synth_corpus import heldout_clip, synth_corpus
from viettts_tpu_torch.tools.validate_int8 import (
    DEFAULT_CKPT,
    DEFAULT_CORPUS,
    float32_convs,
    load_trained_generator,
)
from viettts_tpu_torch.train.common import resolve_device

VARIANTS = {
    "full_static_per_conv": dict(quant_w=True, act_mode="per_conv"),
    "weights_only": dict(quant_w=True, act_mode="none"),
    "acts_only_per_conv": dict(quant_w=False, act_mode="per_conv"),
    "acts_per_channel": dict(quant_w=True, act_mode="per_channel"),
    "acts_p999_clip": dict(quant_w=True, act_mode="p999"),
}


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake quantization of a conv weight
    (O, I, k): ``quantize_weight_int8``'s scales and half-even codes,
    dequantized."""
    s = w.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(w / s).clamp(-127, 127) * s


def fake_quant_act(x: torch.Tensor, mode: str, info: dict) -> torch.Tensor:
    """x [B, C, T] clipped at the calibrated amax of ``mode`` (one value, or
    one per channel for ``per_channel``) and rounded to its int8 grid."""
    if mode == "none":
        return x
    a = info[mode]
    if mode == "per_channel":
        a = a[None, :, None]
    s = a / 127.0
    return torch.round(torch.clamp(x, -a, a) / s) * s


def _conv(x: torch.Tensor, conv, dilation: int = 1, quant_w: bool = False) -> torch.Tensor:
    w = conv.weight.float()
    if quant_w:
        w = fake_quant_weight(w)
    k = w.shape[-1]
    return F.conv1d(x, w, conv.bias.float(), padding=dilation * (k - 1) // 2, dilation=dilation)


@torch.no_grad()
def generator_walk(gen, mel: torch.Tensor, *, quant_w: bool = False, act_mode: str = "none",
                   calib: Optional[List[dict]] = None, record: Optional[List[dict]] = None) -> torch.Tensor:
    """The plain float32 generator on ``mel`` [B, T, n_mels] -> [B, T*256, 1],
    with its MRF convs fake-quantized (``quant_w``: weights; ``act_mode``
    with ``calib[i]``: conv i's input) in the flat conv order of K3.  With
    ``record`` it appends each MRF conv input's statistics (amax, rms,
    99.9th percentile of |x|, per-channel amax) and quantizes nothing."""
    cfg = gen.cfg
    n = len(cfg.resblock_kernel_sizes)
    counter = [0]

    def mrf_conv(x, conv, dilation):
        if record is not None:
            a = x.abs()
            record.append({"amax": float(a.max()), "rms": float(torch.sqrt(torch.mean(x * x))),
                           "p999": float(torch.quantile(a.flatten(), 0.999)),
                           "per_channel": a.amax(dim=(0, 2))})
            y = _conv(x, conv, dilation)
        else:
            if calib is not None:
                x = fake_quant_act(x, act_mode, calib[counter[0]])
            y = _conv(x, conv, dilation, quant_w)
        counter[0] += 1
        return y

    x = _conv(mel.float().transpose(1, 2), gen.conv_pre)
    for i, (ups, u) in enumerate(zip(gen.ups, cfg.upsample_rates)):
        x = conv_transpose_same(F.leaky_relu(x, LRELU_SLOPE), ups.weight.float(), ups.bias.float(), u)
        acc = None
        for rb in gen.resblocks[i * n:(i + 1) * n]:
            r = x
            for j, d in enumerate(rb.dilations):
                y = mrf_conv(F.leaky_relu(r, LRELU_SLOPE), rb.convs1[j], d)
                if rb.convs2 is not None:
                    y = mrf_conv(F.leaky_relu(y, LRELU_SLOPE), rb.convs2[j], 1)
                r = y + r
            acc = r if acc is None else acc + r
        x = acc / n
    x = _conv(F.leaky_relu(x, POST_LRELU_SLOPE), gen.conv_post)
    return torch.tanh(x).transpose(1, 2)


def rel_rms(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.sqrt(((a - b) ** 2).mean()) / max(np.sqrt((b**2).mean()), 1e-12))


def calibration(record: List[dict], margin: float) -> List[dict]:
    """Per-conv activation scales of each mode from a recording walk."""
    return [{"per_conv": r["amax"] * margin, "p999": r["p999"], "per_channel": r["per_channel"] * margin}
            for r in record]


def crest_factors(record: List[dict]) -> Dict:
    crest = [r["amax"] / max(r["rms"], 1e-12) for r in record]
    return {"min": min(crest), "max": max(crest), "mean": float(np.mean(crest)),
            "per_conv": [round(c, 1) for c in crest]}


def stage_scales(gen, calib: List[dict]) -> Dict[int, torch.Tensor]:
    """The per-conv static scales as ``generator_apply_fused`` takes them,
    ``{stage: [n_convs]}`` (the walk's flat order split by stage)."""
    cfg = gen.cfg
    per_stage = sum(len(d) * (2 if cfg.resblock == "1" else 1) for d in cfg.resblock_dilation_sizes)
    flat = torch.tensor([c["per_conv"] for c in calib], dtype=torch.float32, device=gen.conv_pre.weight.device)
    return {i: flat[i * per_stage:(i + 1) * per_stage] for i in range(len(cfg.upsample_rates))}


def random_generator(cfg: Config, device):
    """The GAN trainer's cold-initialised generator, folded (random
    weights, for the crest-factor comparison)."""
    from viettts_tpu_torch.checkpoint import gan_tree, load_generator
    from viettts_tpu_torch.models.discriminators import init_gan_params
    from viettts_tpu_torch.models.hifigan import Generator

    wn = Generator(cfg.hifigan, use_wn=True)
    init_gan_params(wn, torch.Generator().manual_seed(cfg.train.seed))
    gen = Generator(cfg.hifigan)
    load_generator(gen, {"params": gan_tree(dict(wn.named_parameters()), cfg.hifigan.resblock == "2")})
    return gen.to(device).eval().requires_grad_(False)


def run(
    ckpt: Path = DEFAULT_CKPT,
    corpus: Path = DEFAULT_CORPUS,
    margin: float = 1.25,
    out: Optional[Path] = Path("runs/diagnose_int8"),
    device="cuda",
    cfg: Config = Config(),
) -> dict:
    """The decomposition on the held-out clip, calibrated on the first
    corpus clip; written to ``out``/``int8_diagnosis.json`` (none when
    None)."""
    from viettts_tpu_torch.models.hifigan import generator_apply_fused

    device = resolve_device(device)
    gen = load_trained_generator(ckpt, cfg, device)
    if not (Path(corpus) / "syn000.wav").exists():
        synth_corpus(corpus, n=1)
    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    hop = cfg.dsp.hop_length

    def clip_mel(w: np.ndarray) -> torch.Tensor:
        w = w[: len(w) // hop * hop].astype(np.float32)
        with torch.no_grad():
            return mel_fn(torch.from_numpy(w)[None].to(device))

    cal_mel = clip_mel(read_wav(Path(corpus) / "syn000.wav")[1].astype(np.float32) / 2**15)
    eval_mel = clip_mel(heldout_clip())
    with float32_convs():
        record: List[dict] = []
        generator_walk(gen, cal_mel, record=record)
        calib = calibration(record, margin)
        ref = generator_walk(gen, eval_mel).cpu()
        results = {}
        for name, kw in VARIANTS.items():
            results[name] = rel_rms(generator_walk(gen, eval_mel, calib=calib, **kw).cpu(), ref)
            print(f"{name:24s} rel-RMS vs f32: {results[name]:.4%}", flush=True)
        random_record: List[dict] = []
        generator_walk(random_generator(cfg, device), cal_mel, record=random_record)
        f32 = gen(eval_mel).cpu()
    with torch.no_grad():
        scales = stage_scales(gen, calib)
        kernel = generator_apply_fused(gen, eval_mel, torch.bfloat16, quantize_int8=True, act_scales=scales).cpu()
        bf16 = generator_apply_fused(gen, eval_mel, torch.bfloat16).cpu()
    measured, bf16_err = rel_rms(kernel, f32), rel_rms(bf16, f32)
    sim = results["full_static_per_conv"]
    gap = measured - sim
    fault = abs(gap) > 0.25 * sim + bf16_err + 1e-3
    print(f"{'K3' if device.type == 'cuda' else 'plain twin'} static route rel-RMS vs f32: {measured:.4%} "
          f"(simulation {sim:.4%}, bf16 route {bf16_err:.4%}): gap {gap:+.4%}"
          + (" -- KERNEL FAULT" if fault else ""), flush=True)
    result = {
        "ckpt": str(ckpt),
        "margin": margin,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "rel_rms_vs_f32": results,
        "kernel_route": "K3 (csrc/mrf_int8.cu)" if device.type == "cuda" else "plain twin (CPU)",
        "kernel_measured_static": measured,
        "bf16_route_rel_rms_vs_f32": bf16_err,
        "kernel_minus_simulation": gap,
        "kernel_fault": bool(fault),
        "mrf_input_crest_factors": crest_factors(record),
        "mrf_input_crest_factors_random": crest_factors(random_record),
    }
    if out is not None:
        Path(out).mkdir(parents=True, exist_ok=True)
        with open(Path(out) / "int8_diagnosis.json", "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    from argparse import ArgumentParser

    parser = ArgumentParser(description="Decompose the int8 vocoder's error on trained weights")
    parser.add_argument("--ckpt", type=Path, default=DEFAULT_CKPT, help="trained generator checkpoint")
    parser.add_argument("--corpus-dir", type=Path, default=DEFAULT_CORPUS, help="the GAN corpus (first clip)")
    parser.add_argument("--margin", type=float, default=1.25)
    parser.add_argument("--out", type=Path, default=Path("runs/diagnose_int8"))
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    parser.add_argument("--set", action="append", default=[], metavar="K=V")
    args = parser.parse_args(argv)
    result = run(args.ckpt, args.corpus_dir, args.margin, args.out, args.device, apply_overrides(Config(), args.set))
    print(json.dumps({k: v for k, v in result.items() if not k.startswith("mrf_input")}, indent=1))
    print(json.dumps(result["mrf_input_crest_factors"]["per_conv"][:12]))
    return 1 if result["kernel_fault"] else 0


if __name__ == "__main__":
    sys.exit(main())
