"""int8 and bf16 vocoder quality on trained weights (counterpart of
``scripts/validate_int8.py``).

    python -m viettts_tpu_torch.tools.validate_int8 [--ckpt CKPT] [--corpus-dir DIR] [--n-eval 6] \\
        [--margin 1.25] [--out runs/validate_int8] [--device cuda] [--set K=V ...]

Loads a trained generator checkpoint (``tools.validate_gan``'s by default),
vocodes real log-mels of the synthetic GAN corpus's distribution and holds
each serving route against the plain float32 generator
(``Generator.forward``) on the same mel:

* the bf16 route (``generator_apply_fused``, bf16 storage: kernel K2 on
  the card);
* the static int8 route (kernel K3), calibrated as ``Synthesizer.
  calibrate_int8`` does: per-conv amaxes maxed over 4 calibration clips,
  disjoint from the evaluation clips, widened by ``--margin``;
* the dynamic int8 route (K3, per-row activation scales).

For each evaluation clip (the never-trained seed-12345 probe, then the last
``n_eval - 1`` corpus clips) it reports the waveform rel-RMS and max abs
error against float32, the MCD (dB) between the re-analyzed log-mels and
the static route's largest clip fraction; then means and maxima, in
``--out``/``int8_quality.json``, with ``scripts/validate_int8.py``'s keys.
``--n-eval 1`` evaluates the probe clip alone.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from viettts_tpu_torch.audio import read_wav
from viettts_tpu_torch.config import Config, apply_overrides
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.tools.synth_corpus import heldout_clip, synth_corpus
from viettts_tpu_torch.train.common import resolve_device
from viettts_tpu_torch.utils.metrics import mel_cepstral_distortion

DEFAULT_CKPT = Path("runs/validate_gan/ckpt/hifigan_latest_ckpt.pickle")
DEFAULT_CORPUS = Path("runs/validate_gan/corpus")
N_CALIBRATION = 4
CORPUS_CLIPS = 48


def load_trained_generator(ckpt: Path, cfg: Config, device):
    """The plain ``Generator`` of a checkpoint's folded params on
    ``device``, in inference mode."""
    from viettts_tpu_torch.checkpoint import load_generator, load_variables
    from viettts_tpu_torch.models.hifigan import Generator

    gen = Generator(cfg.hifigan)
    load_generator(gen, load_variables(ckpt, "hifigan"))
    return gen.to(device).eval().requires_grad_(False)


def corpus_mels(corpus: Path, n_eval: int, cfg: Config, device) -> Tuple[List[torch.Tensor], List[Tuple[str, torch.Tensor]]]:
    """(calibration mels, [(name, evaluation mel)]), each [1, T, mel_dim]:
    calibration on the first 4 corpus clips; evaluation on the held-out
    probe and the last ``n_eval - 1`` corpus clips (none for 1).  Renders
    the 48-clip corpus into ``corpus`` when it holds fewer."""
    if len(list(Path(corpus).glob("*.wav"))) < CORPUS_CLIPS:
        synth_corpus(corpus, n=CORPUS_CLIPS)
    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    hop = cfg.dsp.hop_length

    def mel_of(w: np.ndarray) -> torch.Tensor:
        w = w[: len(w) // hop * hop].astype(np.float32)
        with torch.no_grad():
            return mel_fn(torch.from_numpy(w)[None].to(device))

    def load(f: Path) -> np.ndarray:
        return read_wav(f)[1].astype(np.float32) / 2**15

    files = sorted(Path(corpus).glob("*.wav"))
    eval_files = files[len(files) - (n_eval - 1):] if n_eval > 1 else []
    calib = [mel_of(load(f)) for f in files[:N_CALIBRATION]]
    evals = [("heldout_seed12345", mel_of(heldout_clip()))] + [(f.stem, mel_of(load(f))) for f in eval_files]
    return calib, evals


@torch.no_grad()
def calibrate(gen, mels: Sequence[torch.Tensor], margin: float) -> Dict[int, torch.Tensor]:
    """Static int8 scales: per-conv amaxes maxed over ``mels``, times
    ``margin`` (``Synthesizer.calibrate_int8``'s recipe)."""
    from viettts_tpu_torch.models.hifigan import generator_calibrate_int8

    scales = generator_calibrate_int8(gen, mels[0])
    for m in mels[1:]:
        for i, s in generator_calibrate_int8(gen, m).items():
            scales[i] = torch.maximum(scales[i], s)
    return {i: s * margin for i, s in scales.items()}


@contextlib.contextmanager
def float32_convs():
    """cuDNN convs and matmuls in float32, not TF32 (PyTorch's default for
    cuDNN convs on the card), for the float32 reference; restored on exit."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@torch.no_grad()
def route_waves(gen, mel: torch.Tensor, scales: Dict[int, torch.Tensor]) -> Dict[str, np.ndarray]:
    """float64 waveforms of one mel on the four routes: ``f32`` (the plain
    generator), ``bf16`` (K2), ``int8`` (static scales, K3) and
    ``int8_dynamic`` (K3)."""
    from viettts_tpu_torch.models.hifigan import generator_apply_fused

    bf16 = torch.bfloat16
    with float32_convs():
        f32 = gen(mel)
    waves = {
        "f32": f32,
        "bf16": generator_apply_fused(gen, mel, bf16),
        "int8": generator_apply_fused(gen, mel, bf16, quantize_int8=True, act_scales=scales),
        "int8_dynamic": generator_apply_fused(gen, mel, bf16, quantize_int8=True),
    }
    return {k: v.double().cpu().numpy() for k, v in waves.items()}


def clip_metrics(name: str, waves: Dict[str, np.ndarray], mel_fn, max_clip: float) -> dict:
    """One clip's row of the result: each route's rel-RMS against float32,
    the static route's max abs error, and the MCDs of the re-analyzed
    log-mels."""
    w_f32 = waves["f32"]
    f32_rms = max(float(np.sqrt((w_f32**2).mean())), 1e-12)

    def rel_rms_of(w):
        return float(np.sqrt(((w - w_f32) ** 2).mean()) / f32_rms)

    def mcd_of(w):
        def log_mel(a):
            return mel_fn(torch.from_numpy(a[..., 0]).float().to(mel_fn.melfb_t.device))

        return float(mel_cepstral_distortion(log_mel(w_f32), log_mel(w)))

    return {
        "clip": name,
        "rel_rms_vs_f32": rel_rms_of(waves["int8"]),
        "bf16_rel_rms_vs_f32": rel_rms_of(waves["bf16"]),
        "int8_dynamic_rel_rms_vs_f32": rel_rms_of(waves["int8_dynamic"]),
        "max_abs_err": float(np.abs(waves["int8"] - w_f32).max()),
        "f32_rms": f32_rms,
        "mcd_db_int8_vs_f32": mcd_of(waves["int8"]),
        "mcd_db_bf16_vs_f32": mcd_of(waves["bf16"]),
        "mcd_db_int8_dynamic_vs_f32": mcd_of(waves["int8_dynamic"]),
        "max_clip_fraction": max_clip,
    }


def summarize(per_clip: List[dict], ckpt, n_calibration: int, margin: float, device) -> dict:
    """The result dict of ``scripts/validate_int8.py`` over ``per_clip``."""

    def mean(key):
        return float(np.mean([c[key] for c in per_clip]))

    def peak(key):
        return float(np.max([c[key] for c in per_clip]))

    return {
        "ckpt": str(ckpt),
        "weights": "TRAINED (framework GAN run)",
        "backend": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "calibration": {"n_clips": n_calibration, "margin": margin, "disjoint_from_eval": True},
        "rel_rms_vs_f32_mean": mean("rel_rms_vs_f32"),
        "rel_rms_vs_f32_max": peak("rel_rms_vs_f32"),
        "mcd_db_int8_vs_f32_mean": mean("mcd_db_int8_vs_f32"),
        "mcd_db_int8_vs_f32_max": peak("mcd_db_int8_vs_f32"),
        "bf16_rel_rms_vs_f32_mean": mean("bf16_rel_rms_vs_f32"),
        "bf16_rel_rms_vs_f32_max": peak("bf16_rel_rms_vs_f32"),
        "mcd_db_bf16_vs_f32_mean": mean("mcd_db_bf16_vs_f32"),
        "mcd_db_bf16_vs_f32_max": peak("mcd_db_bf16_vs_f32"),
        "int8_dynamic_rel_rms_vs_f32_mean": mean("int8_dynamic_rel_rms_vs_f32"),
        "mcd_db_int8_dynamic_vs_f32_mean": mean("mcd_db_int8_dynamic_vs_f32"),
        "max_clip_fraction": peak("max_clip_fraction"),
        "per_clip": per_clip,
    }


def run(
    ckpt: Path = DEFAULT_CKPT,
    corpus: Path = DEFAULT_CORPUS,
    n_eval: int = 6,
    margin: float = 1.25,
    out: Optional[Path] = Path("runs/validate_int8"),
    device="cuda",
    cfg: Config = Config(),
) -> dict:
    """Calibrate, vocode every evaluation clip on the four routes, and
    write ``int8_quality.json`` into ``out`` (none when None)."""
    from viettts_tpu_torch.models.hifigan import generator_int8_clip_stats

    if n_eval < 1:
        raise ValueError(f"--n-eval must be at least 1, got {n_eval}")
    device = resolve_device(device)
    gen = load_trained_generator(ckpt, cfg, device)
    calib, evals = corpus_mels(corpus, n_eval, cfg, device)
    scales = calibrate(gen, calib, margin)
    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    per_clip = []
    for name, mel in evals:
        with torch.no_grad():
            fracs = generator_int8_clip_stats(gen, mel, scales)
            c = clip_metrics(name, route_waves(gen, mel, scales), mel_fn,
                             max(float(v.max()) for v in fracs.values()))
        per_clip.append(c)
        print(f"{name:>24s}  int8 rel_rms {c['rel_rms_vs_f32']:.5f} mcd {c['mcd_db_int8_vs_f32']:.3f} dB | "
              f"dyn {c['int8_dynamic_rel_rms_vs_f32']:.5f} mcd {c['mcd_db_int8_dynamic_vs_f32']:.3f} dB | "
              f"bf16 rel_rms {c['bf16_rel_rms_vs_f32']:.5f} mcd {c['mcd_db_bf16_vs_f32']:.3f} dB | "
              f"clip_frac {c['max_clip_fraction']:.2e}", flush=True)
    result = summarize(per_clip, ckpt, len(calib), margin, device)
    if out is not None:
        Path(out).mkdir(parents=True, exist_ok=True)
        with open(Path(out) / "int8_quality.json", "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    from argparse import ArgumentParser

    parser = ArgumentParser(description="int8 and bf16 vocoder quality against float32 on trained weights")
    parser.add_argument("--ckpt", type=Path, default=DEFAULT_CKPT, help="trained generator checkpoint")
    parser.add_argument("--corpus-dir", type=Path, default=DEFAULT_CORPUS, help="the GAN corpus (rendered if short)")
    parser.add_argument("--n-eval", type=int, default=6)
    parser.add_argument("--margin", type=float, default=1.25)
    parser.add_argument("--out", type=Path, default=Path("runs/validate_int8"))
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    parser.add_argument("--set", action="append", default=[], metavar="K=V")
    args = parser.parse_args(argv)
    result = run(args.ckpt, args.corpus_dir, args.n_eval, args.margin, args.out, args.device,
                 apply_overrides(Config(), args.set))
    print(json.dumps({k: v for k, v in result.items() if k != "per_clip"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
