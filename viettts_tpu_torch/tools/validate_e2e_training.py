"""Train from scratch, then synthesize (counterpart of
``scripts/validate_e2e_training.py``).

    python -m viettts_tpu_torch.tools.validate_e2e_training [dur_steps] [ac_steps] [gan_steps] \\
        [--tiny] [--skip-train] [--out runs/validate_e2e_training] [--device cuda]

Renders the aligned synthetic corpus (``tools.synth_corpus.build_corpus``:
64 utterances whose phonemes have fixed acoustic signatures and mean
durations), trains the duration model, the acoustic model and the HiFi-GAN
vocoder from scratch with the port's trainers (600 / 1,500 / 500 steps by
default, at the full reference widths, ``max_phoneme_seq_len=64`` and
``max_wave_len=256*320``), then synthesizes the held-out sentence
``HELD_OUT`` through ``Synthesizer`` from those checkpoints alone (kernels
K1 and K2 on the card).  Pass criteria, in ``result.json``:

* duration: the predicted per-phoneme durations within 0.35 mean absolute
  relative error of the corpus's generative means;
* acoustic: the validation loss below 60% of its value at initialisation;
* content: the synthesized log-mel's Pearson r with the log-mel of the same
  sentence rendered by the corpus generator at the predicted durations,
  after linear time alignment, above 0.5;
* audio: a finite, non-silent waveform (``sample.wav``).

``--tiny`` shrinks every model (a plumbing check: the learning criteria
fail there); ``--skip-train`` synthesizes from the checkpoints of an
earlier run in ``--out`` and carries its training metrics forward.
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from viettts_tpu_torch.audio import write_wav
from viettts_tpu_torch.config import (
    ALL_PHONEMES,
    AcousticModelConfig,
    Config,
    DataConfig,
    DurationModelConfig,
    HifiGanConfig,
    TrainConfig,
)
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.tools.synth_corpus import DUR_MEAN, HELD_OUT, SR, build_corpus, render_phoneme
from viettts_tpu_torch.train.common import resolve_device

HOP = 256
SILENCES = ("sil", "sp", "spn", " ")


def log_mel_of(wav_f32: np.ndarray, cfg: Config) -> np.ndarray:
    """[T, n_mels] log-mel of a float waveform, cut to whole hops."""
    n = len(wav_f32) // HOP * HOP
    with torch.no_grad():
        return LogMelSpectrogram(cfg.dsp)(torch.from_numpy(np.asarray(wav_f32[:n], np.float32))[None])[0].numpy()


def time_align(a: np.ndarray, n: int) -> np.ndarray:
    """Linear time interpolation of a [T, D] mel to n frames."""
    src = np.linspace(0, a.shape[0] - 1, n)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, a.shape[0] - 1)
    f = (src - lo)[:, None]
    return a[lo] * (1 - f) + a[hi] * f


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def duration_error(tokens, dur_s) -> float:
    """Mean absolute relative error of the predicted durations of the
    phonemes with a generative mean."""
    errs = [abs(float(d) - DUR_MEAN[ALL_PHONEMES[t]]) / DUR_MEAN[ALL_PHONEMES[t]]
            for t, d in zip(tokens, dur_s) if ALL_PHONEMES[t] in DUR_MEAN]
    return float(np.mean(errs))


def reference_rendering(tokens, dur_s) -> np.ndarray:
    """The corpus generator's rendering of ``tokens`` at the predicted
    durations (seed 123), the pipeline's trimmed trailing silence left out:
    the same timing on both sides, so the correlation measures content."""
    rng = np.random.RandomState(123)
    items = list(zip(tokens, np.asarray(dur_s)))
    if items and ALL_PHONEMES[items[-1][0]] == "sil":
        items = items[:-1]
    parts = []
    for tok, d in items:
        ph = ALL_PHONEMES[tok]
        if float(d) <= 0:
            continue
        if ph in SILENCES:
            parts.append(np.zeros(int(round(float(d) * SR))))
        else:
            parts.append(render_phoneme(ph, float(d), rng))
    wav = np.concatenate(parts)
    return 0.7 * wav / max(np.abs(wav).max(), 1e-6)


def base_config(corpus: Path, ckpt_dir: Path, tiny: bool) -> Config:
    """JAX's ``DataConfig(max_phoneme_seq_len=64, max_wave_len=256*320)``,
    prenet dropout off at inference; with ``tiny`` the plumbing-check
    widths."""
    cfg = Config(data=DataConfig(max_phoneme_seq_len=64, max_wave_len=256 * 320),
                 acoustic=AcousticModelConfig(prenet_dropout_at_inference=False),
                 ckpt_dir=ckpt_dir, data_dir=corpus)
    if tiny:
        cfg = cfg.replace(
            duration=DurationModelConfig(lstm_dim=16),
            acoustic=AcousticModelConfig(encoder_dim=16, decoder_dim=16, prenet_dim=8, postnet_dim=8,
                                         prenet_dropout_at_inference=False),
            hifigan=HifiGanConfig(upsample_initial_channel=32, segment_size=4096),
        )
    return cfg


def train_all(base: Config, corpus: Path, steps: Sequence[int], device, step_logs=None) -> dict:
    """The three trainers from scratch; the acoustic validation loss at
    initialisation and after training.  ``step_logs`` (a dict) collects
    each trainer's per-step log."""
    from viettts_tpu_torch.data.loader import AcousticDataset, to_device
    from viettts_tpu_torch.models.acoustic import AcousticModel
    from viettts_tpu_torch.models.layers import batch_stats
    from viettts_tpu_torch.train import acoustic, duration, hifigan

    dur_steps, ac_steps, gan_steps = steps

    def log(kind):  # a step log makes each step wait for the device
        return None if step_logs is None else step_logs.setdefault(kind, [])

    result = {}
    cfg = base.replace(train=TrainConfig(batch_size=32, num_training_steps=dur_steps,
                                         duration_learning_rate=3e-4, ckpt_interval=200))
    t0 = time.perf_counter()
    duration.train(cfg, device=device, step_log=log("duration"))
    result["duration_steps"] = dur_steps
    result["duration_steps_per_sec"] = round(dur_steps / (time.perf_counter() - t0), 2)

    cfg = base.replace(train=TrainConfig(batch_size=32, num_training_steps=ac_steps, learning_rate=3e-4,
                                         ckpt_interval=500))
    val_ds = AcousticDataset(corpus, 64, cfg.data.max_wave_len, "val", cfg.data, SR)
    vb = to_device(next(val_ds.batches(len(val_ds), seed=0)), device)
    model = AcousticModel(cfg.acoustic)
    model.init_params(torch.Generator().manual_seed(cfg.train.seed))  # the trainer's initial weights
    model.to(device)
    loss_fn = acoustic.make_loss_fn(model, LogMelSpectrogram(cfg.dsp).to(device), HOP, train=False)
    rng = torch.Generator(device).manual_seed(0)
    with torch.no_grad():
        init_loss = float(loss_fn(dict(model.named_parameters()), batch_stats(model), rng, vb)[0])
    t0 = time.perf_counter()
    state = acoustic.train(cfg, save_plots=False, device=device, step_log=log("acoustic"))
    result["acoustic_steps"] = ac_steps
    result["acoustic_steps_per_sec"] = round(ac_steps / (time.perf_counter() - t0), 2)
    with torch.no_grad():
        final_loss = float(loss_fn(state.params, state.batch_stats, rng, vb)[0])
    result["acoustic_val_loss_init"] = round(init_loss, 4)
    result["acoustic_val_loss_final"] = round(final_loss, 4)

    cfg = base.replace(train=TrainConfig(batch_size=16, num_training_steps=gan_steps))
    t0 = time.perf_counter()
    hifigan.train(cfg, wav_dir=corpus, num_steps=gan_steps, log_every=100, device=device,
                  step_log=log("gan"))
    result["gan_steps"] = gan_steps
    result["gan_steps_per_sec"] = round(gan_steps / (time.perf_counter() - t0), 2)
    return result


def run(
    dur_steps: int = 600,
    ac_steps: int = 1500,
    gan_steps: int = 500,
    tiny: bool = False,
    skip_train: bool = False,
    out: Path = Path("runs/validate_e2e_training"),
    device="cuda",
    step_logs: Optional[dict] = None,
) -> dict:
    """Train (unless ``skip_train``), synthesize ``HELD_OUT``, check the
    four criteria; writes ``result.json`` and ``sample.wav`` into ``out``."""
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    device = resolve_device(device)
    out = Path(out)
    corpus, ckpt_dir = out / "corpus", out / "ckpt"
    if not skip_train:
        for d in (corpus, ckpt_dir):
            if d.exists():
                shutil.rmtree(d)
        ckpt_dir.mkdir(parents=True)
    if not (corpus / "lexicon.txt").exists():
        build_corpus(corpus)
    base = base_config(corpus, ckpt_dir, tiny)

    result = {}
    if skip_train:
        prev = out / "result.json"
        if prev.exists():  # the recorded training metrics
            result = {k: v for k, v in json.loads(prev.read_text()).items() if not k.startswith("ok_")}
    else:
        result = train_all(base, corpus, (dur_steps, ac_steps, gan_steps), device, step_logs)
    ok_acoustic = result.get("acoustic_val_loss_final", 1e9) < 0.6 * result.get("acoustic_val_loss_init", 0.0)

    synth = Synthesizer(base, lexicon_file=corpus / "lexicon.txt", device=device)
    r = synth.synthesize(HELD_OUT)
    wav = np.asarray(r.wave, np.float32)
    write_wav(out / "sample.wav", wav, SR)
    result["sample_seconds"] = round(len(wav) / SR, 3)
    result["sample_rms"] = round(float(np.sqrt(np.mean(wav**2))), 4)
    ok_audio = bool(np.isfinite(wav).all() and result["sample_rms"] > 0.01)

    toks = synth.text_to_token_ids(HELD_OUT)
    _, _, dur_s = synth._durations_for([toks], -1.0)
    result["duration_mean_abs_rel_err"] = round(duration_error(toks, dur_s[0]), 4)
    ok_duration = result["duration_mean_abs_rel_err"] < 0.35

    ref_mel = log_mel_of(reference_rendering(toks, dur_s[0]).astype(np.float32), base)
    pred_mel = np.asarray(r.mel)
    result["mel_corr_vs_generator"] = round(pearson(time_align(ref_mel, pred_mel.shape[0]), pred_mel), 4)
    ok_content = result["mel_corr_vs_generator"] > 0.5

    result.update(ok_acoustic_loss=bool(ok_acoustic), ok_duration=bool(ok_duration), ok_content=bool(ok_content),
                  ok_audio=ok_audio,
                  backend=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    with open(out / "result.json", "w") as f:
        json.dump(result, f, indent=1)
    return result


def passed(result: dict) -> bool:
    return all(v for k, v in result.items() if k.startswith("ok_"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    from argparse import ArgumentParser

    parser = ArgumentParser(description="Train the three models from scratch on a synthetic corpus, then synthesize")
    parser.add_argument("steps", nargs="*", type=int, help="duration, acoustic and GAN steps (600 1500 500)")
    parser.add_argument("--tiny", action="store_true", help="tiny widths: a plumbing check")
    parser.add_argument("--skip-train", action="store_true", help="synthesize from the checkpoints in --out")
    parser.add_argument("--out", type=Path, default=Path("runs/validate_e2e_training"))
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    if len(args.steps) > 3:
        parser.error("at most three step counts")
    result = run(*args.steps, tiny=args.tiny, skip_train=args.skip_train, out=args.out, device=args.device)
    print(json.dumps(result, indent=1))
    ok = passed(result)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
