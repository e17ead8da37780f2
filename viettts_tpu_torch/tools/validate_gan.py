"""HiFi-GAN training validation on the card (counterpart of
``scripts/validate_gan.py``).

    python -m viettts_tpu_torch.tools.validate_gan [steps] [--gta] [--resume] [--corpus N] \\
        [--out runs/validate_gan] [--device cuda] [--set K=V ...]

Renders the synthetic speech-like corpus (``tools.synth_corpus``: ``N``
clips of the seed-0 stream, 48 by default), trains the vocoder through
``viettts_tpu_torch.train.hifigan.train`` at the full model size (B=16 and
``HifiGanConfig``'s segment unless ``--set`` says otherwise) and records:

* the disc / gen / mel_l1 history (every step to 50, then every 10th);
* the held-out MCD: the seed-12345 probe clip, which the corpus never
  holds, resynthesized by the live weight-normalized generator every
  ``max(50, steps // 40)`` steps;
* steps/s over the whole run and over its back half (no warm-up);
* ``gan_training.json`` (``gan_training_gta.json`` with ``--gta``) and a
  sample WAV vocoded from the folded checkpoint through the serving
  generator on the float32 route (kernel K2 on the card), in ``--out``.

Pass (printed last, exit code 0): mel_l1 of the last 150 steps at least 30%
below its first-50-step mean (below it, resumed), and finite losses.

``--gta`` trains mel-conditioned on per-utterance mels of the audio in the
``tools.gta`` [D, T] ``.npy`` format.  ``--resume`` continues the
checkpoint in ``--out`` (``steps`` is then the total) with
``lr_decay_steps=819``, the upstream LJSpeech epoch (13100 clips / batch
16), so the per-epoch decay does not collapse the learning rate on a small
corpus.  The corpus, checkpoint and GTA mels live under ``--out``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from viettts_tpu_torch.audio import read_wav, write_wav
from viettts_tpu_torch.config import Config, TrainConfig, apply_overrides
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.tools.synth_corpus import SR, heldout_clip, synth_corpus
from viettts_tpu_torch.train.common import resolve_device
from viettts_tpu_torch.utils.metrics import mel_cepstral_distortion

LOSSES = ("disc_loss", "gen_loss", "mel_l1")


def make_gta_mels(corpus: Path, gta_dir: Path, cfg: Config, device) -> None:
    """Per-utterance conditioning mels of the audio, [D, T] ``.npy`` as
    ``tools.gta`` writes them; files that exist are kept."""
    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    hop = cfg.dsp.hop_length
    gta_dir.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        for wav_file in sorted(corpus.glob("*.wav")):
            out = gta_dir / f"{wav_file.stem}.npy"
            if out.exists():
                continue
            y = read_wav(wav_file)[1].astype(np.float32) / 2**15
            y = y[: len(y) // hop * hop]
            mel = mel_fn(torch.from_numpy(y)[None].to(device))[0]
            np.save(out, mel.cpu().numpy().T)


def mcd_probe(cfg: Config, device):
    """``probe(gen_params) -> MCD (dB)`` of the held-out clip against its
    resynthesis by the weight-normalized generator at ``gen_params`` (the
    trainer's compute dtype)."""
    from torch.func import functional_call

    from viettts_tpu_torch.models.hifigan import Generator

    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    held = torch.from_numpy(heldout_clip()[: SR * 2 // 256 * 256]).to(device)
    gen = Generator(cfg.hifigan, use_wn=True,
                    dtype=torch.bfloat16 if cfg.train.mixed_precision else torch.float32).to(device)

    @torch.no_grad()
    def probe(gen_params) -> float:
        mel_ref = mel_fn(held[None])
        wav = functional_call(gen, gen_params, (mel_ref,))
        return float(mel_cepstral_distortion(mel_ref, mel_fn(wav[..., 0].float())))

    return probe


def vocode_sample(ckpt: Path, wav: Path, cfg: Config, device) -> np.ndarray:
    """The folded generator of ``ckpt`` on the serving path's float32 route
    (``generator_apply_fused``: kernel K2 on the card) over the log-mel of
    ``wav``'s first two seconds."""
    from viettts_tpu_torch.models.hifigan import generator_apply_fused
    from viettts_tpu_torch.tools.validate_int8 import load_trained_generator

    gen = load_trained_generator(ckpt, cfg, device)
    ref = read_wav(wav)[1].astype(np.float32) / 2**15
    with torch.no_grad():
        cond = LogMelSpectrogram(cfg.dsp).to(device)(torch.from_numpy(ref[: SR * 2 // 256 * 256])[None].to(device))
        out = generator_apply_fused(gen, cond, torch.float32)
    return out[0, :, 0].cpu().numpy()


def run(
    steps: int = 600,
    gta: bool = False,
    resume: bool = False,
    corpus_n: int = 48,
    out: Path = Path("runs/validate_gan"),
    device="cuda",
    overrides: Sequence[str] = (),
) -> dict:
    """Render the corpus, train, probe and write the results; returns the
    result dict (``scripts/validate_gan.py``'s keys and its history)."""
    device = resolve_device(device)
    out = Path(out)
    corpus, ckpt_dir = out / "corpus", out / "ckpt"
    if len(list(corpus.glob("*.wav"))) < corpus_n:
        synth_corpus(corpus, n=corpus_n)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if not resume:
        for old in ckpt_dir.glob("*"):
            old.unlink()
    cfg = Config(train=TrainConfig(batch_size=16, num_training_steps=steps), ckpt_dir=ckpt_dir)
    cfg = apply_overrides(cfg, list(overrides))
    if resume:  # the upstream LJSpeech-scale decay epoch; see the module docstring
        cfg = cfg.replace(hifigan=dataclasses.replace(cfg.hifigan, lr_decay_steps=819))
    gta_dir = None
    if gta:
        gta_dir = out / "gta"
        make_gta_mels(corpus, gta_dir, cfg, device)

    history = {"step": [], **{k: [] for k in LOSSES}}
    mcd_history = {"step": [], "mcd_db": []}
    sample_t = []  # (step, host time after the step's metrics were read)
    first_step = []

    def on_metrics(step, metrics):
        if not first_step:
            first_step.append(step)
        if step % 10 == 0 or step <= 50:  # reading a metric waits for the device
            history["step"].append(step)
            for k in LOSSES:
                history[k].append(float(metrics[k]))
        if step % 10 == 0:
            sample_t.append((step, time.perf_counter()))

    probe = mcd_probe(cfg, device)

    def on_state(step, state):
        mcd_history["step"].append(step)
        mcd_history["mcd_db"].append(probe(state.gen_params))

    from viettts_tpu_torch.train import hifigan

    t0 = time.perf_counter()
    hifigan.train(cfg, wav_dir=corpus, gta_dir=gta_dir, num_steps=steps, log_every=100, on_metrics=on_metrics,
                  on_state=on_state, on_state_every=max(50, steps // 40), device=device)
    dt = time.perf_counter() - t0
    done = steps - (first_step[0] - 1 if first_step else steps)
    # the back half's rate: no warm-up, no final checkpoint write
    half = [s for s in sample_t if s[0] >= steps // 2]
    steady = (half[-1][0] - half[0][0]) / max(half[-1][1] - half[0][1], 1e-9) if len(half) > 1 else float("nan")

    mel = np.asarray(history["mel_l1"])
    st = np.asarray(history["step"])
    start_step = first_step[0] - 1 if first_step else 0
    early = mel[st <= start_step + 50].mean()
    late = mel[st > steps - 150].mean()
    # a resumed run starts near convergence: it must not diverge
    ok_decrease = late < (early if resume else 0.7 * early)
    ok_finite = all(np.isfinite(history[k]).all() for k in LOSSES)
    mcd = np.asarray(mcd_history["mcd_db"], np.float64)
    result = {
        "steps": steps,
        "batch_size": cfg.train.batch_size,
        "segment_size": cfg.hifigan.segment_size,
        "steps_per_sec": round(done / dt, 3),
        "steps_per_sec_steady": round(float(steady), 3),
        "mel_l1_first50_avg": round(float(early), 4),
        "mel_l1_last_avg": round(float(late), 4),
        "mel_l1_reduction": round(float(1 - late / early), 4),
        "disc_loss_last": history["disc_loss"][-1],
        "gen_loss_last": history["gen_loss"][-1],
        "mcd_db_first": round(float(mcd[0]), 3) if len(mcd) else None,
        "mcd_db_last": round(float(mcd[-1]), 3) if len(mcd) else None,
        "ok_mel_l1_decreased_30pct": bool(ok_decrease),
        "ok_losses_finite": bool(ok_finite),
        "ok_mcd_decreased": bool(len(mcd) >= 2 and mcd[-1] < mcd[0]),
        "gta_finetune_mode": bool(gta),
        "resumed_from_step": start_step if resume else 0,
        "corpus_clips": len(list(corpus.glob("*.wav"))),
        "lr_decay_steps": cfg.hifigan.lr_decay_steps,
        "heldout_probe": "seed-12345 clip, never in the training corpus",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "history": history,
        "mcd_history": mcd_history,
    }
    with open(out / ("gan_training_gta.json" if gta else "gan_training.json"), "w") as f:
        json.dump(result, f, indent=1)
    if not gta:  # the GTA pass records metrics only
        sample = vocode_sample(ckpt_dir / "hifigan_latest_ckpt.pickle", sorted(corpus.glob("*.wav"))[0], cfg, device)
        write_wav(out / "gan_sample.wav", sample, SR)
    return result


def passed(result: dict) -> bool:
    return result["ok_mel_l1_decreased_30pct"] and result["ok_losses_finite"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    from argparse import ArgumentParser

    parser = ArgumentParser(description="Validate HiFi-GAN training on a synthetic corpus")
    parser.add_argument("steps", nargs="?", type=int, default=600)
    parser.add_argument("--gta", action="store_true", help="train on GTA-format mels of the audio")
    parser.add_argument("--resume", action="store_true", help="continue the checkpoint in --out to STEPS")
    parser.add_argument("--corpus", type=int, default=48, help="clips of the seed-0 stream")
    parser.add_argument("--out", type=Path, default=Path("runs/validate_gan"))
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    parser.add_argument("--set", action="append", default=[], metavar="K=V")
    args = parser.parse_args(argv)
    result = run(args.steps, args.gta, args.resume, args.corpus, args.out, args.device, args.set)
    print(json.dumps({k: v for k, v in result.items() if k not in ("history", "mcd_history")}, indent=1))
    ok = passed(result)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
