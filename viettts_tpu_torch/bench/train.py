"""Training throughput of the port (counterpart of
``scripts/bench_train.py``).

    python -m viettts_tpu_torch.bench.train [--iters 4] [--warmup 1]

Acoustic: the acoustic trainer's update (``train/acoustic.py``'s loss with
its log-mel targets computed on the device, gradients, clip + AdamW;
``train/common.py::make_update_fn``) at ``Config()`` widths on synthetic
batches of ``scripts/bench_train.py:20-24``'s shape: B=32, 256 tokens,
196,608-sample waveforms (768 frames), ``steps_per_update`` 4, one
warm-up update, then 4 timed updates.  Vocoder: the HiFi-GAN step
(``train/hifigan.py::make_gan_step``: generator, MPD and MSD forward and
backward, both optimizers) at ``HifiGanConfig()`` widths, B=16, one
warm-up step and 6 timed steps, in float32 and under
``train.mixed_precision`` (bf16), as ``bench_gan`` (:113) runs it.
Neither reaches a Pallas kernel in JAX, nor a hand-written kernel here
(cuDNN and eager ops); ``launches`` shows that.

The last line is one JSON object with the keys ``scripts/bench_train.py``
writes to ``benchmarks/train_results.json`` (``vocoder_gan`` holds
``bench_gan``'s) and the port's: ``device``, ``runs_s`` (every timed
update; ``vocoder_gan.runs_s_f32`` and ``runs_s_bf16`` every timed GAN
step) and peak device memory.  The rates divide by the timed runs' sum, as JAX's divide by the
span of its loop.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from viettts_tpu_torch.bench.common import (
    card_line,
    host_runs,
    parser,
    read_counters,
    resolve_device,
    run_main,
    zero_counters,
)
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.data.loader import to_device
from viettts_tpu_torch.models.acoustic import AcousticModel
from viettts_tpu_torch.models.layers import batch_stats
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.train.acoustic import make_loss_fn
from viettts_tpu_torch.train.common import init_train_state, make_optimizer, make_update_fn
from viettts_tpu_torch.train.hifigan import build_gan
from viettts_tpu_torch.types import AcousticBatch

BATCH = 32
SEQ_LEN = 256
WAVE_LEN = 1024 * 64 * 3  # 196608 samples, the corpus cap
STEPS_PER_UPDATE = 4
UPDATES = 4
WARMUP = 1
GAN_BATCH = 16
GAN_STEPS = 6
VOCAB = 93
LEARNING_RATE = 1e-4  # scripts/bench_train.py's make_optimizer(1e-4)


def acoustic_rates(cfg, steps: int, batch: int, wave_len: int, dt: float) -> dict:
    """``scripts/bench_train.py``'s arithmetic: ``steps`` optimizer steps
    of ``batch`` waveforms of ``wave_len`` samples in ``dt`` seconds."""
    return {
        "optimizer_steps_per_sec": steps / dt,
        "examples_per_sec": steps * batch / dt,
        "audio_seconds_trained_per_sec": steps * batch * wave_len / cfg.dsp.sample_rate / dt,
    }


def _peak_memory(device: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def bench_acoustic(cfg: Config, device: torch.device, iters: int, warmup: int, seed: int, batch: int, seq_len: int,
                   wave_len: int, steps_per_update: int) -> dict:
    """``warmup`` then ``iters`` timed updates of ``steps_per_update``
    steps each on one synthetic batch."""
    hop, sr = cfg.dsp.hop_length, cfg.dsp.sample_rate
    rng = np.random.RandomState(seed)
    host = AcousticBatch(
        phonemes=rng.randint(0, VOCAB, (batch, seq_len)).astype(np.int32),
        lengths=np.full((batch,), seq_len, np.int32),
        durations=np.full((batch, seq_len), wave_len / sr / seq_len, np.float32),
        wavs=(rng.randn(batch, wave_len) * 2000).astype(np.int16),
        wav_lengths=np.full((batch,), wave_len, np.int32),
        mels=None,
    )
    batches = [to_device(host, device)] * steps_per_update
    model = AcousticModel(cfg.acoustic)
    model.init_params(torch.Generator().manual_seed(seed))
    model.to(device)
    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    optimizer = make_optimizer(LEARNING_RATE)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), optimizer,
                             torch.Generator(device).manual_seed(seed))
    update = make_update_fn(make_loss_fn(model, mel_fn, hop, train=True), optimizer)
    losses = []

    def one_update():
        nonlocal state
        state, loss = update(state, batches)
        losses.append(float(loss))  # reading the loss waits for the device

    _reset_peak(device)
    runs = host_runs(one_update, device, iters, warmup)
    steps = iters * steps_per_update
    return {"runs": runs, "steps": steps, "final_loss": losses[-1], "peak_memory_bytes": _peak_memory(device),
            **acoustic_rates(cfg, steps, batch, wave_len, sum(runs))}


def bench_gan(cfg: Config, device: torch.device, batch: int = GAN_BATCH, steps: int = GAN_STEPS, warmup: int = WARMUP,
              seed: int = 0) -> dict:
    """The GAN step in float32 and under mixed precision: ``warmup``
    steps, then ``steps`` timed steps on one random batch each."""
    out = {"batch_size": batch}
    for mixed in (False, True):
        gcfg = cfg.replace(train=dataclasses.replace(cfg.train, mixed_precision=mixed, batch_size=batch))
        state, step = build_gan(gcfg, device, gcfg.hifigan.learning_rate)
        rng = np.random.RandomState(seed)
        audio = torch.as_tensor(rng.randn(batch, gcfg.hifigan.segment_size).astype(np.float32) * 0.1, device=device)
        mel_l1 = []

        def one_step():
            nonlocal state
            state, metrics = step(state, None, audio)
            mel_l1.append(float(metrics["mel_l1"]))

        _reset_peak(device)
        runs = host_runs(one_step, device, steps, warmup)
        key = "bf16" if mixed else "f32"
        out[f"steps_per_sec_{key}"] = steps / sum(runs)
        out[f"mel_l1_{key}"] = mel_l1[-1]
        out[f"runs_s_{key}"] = runs
        out[f"peak_memory_bytes_{key}"] = _peak_memory(device)
    return out


def run(cfg: Optional[Config] = None, device="cuda", iters: int = UPDATES, warmup: int = WARMUP, seed: int = 0, *,
        batch: int = BATCH, seq_len: int = SEQ_LEN, wave_len: int = WAVE_LEN,
        steps_per_update: int = STEPS_PER_UPDATE, gan_batch: int = GAN_BATCH, gan_steps: int = GAN_STEPS) -> dict:
    """The acoustic update, then the GAN step; the shapes default to
    ``scripts/bench_train.py``'s."""
    cfg = cfg or Config()
    device = resolve_device(str(device))
    zero_counters()
    acoustic = bench_acoustic(cfg, device, iters, warmup, seed, batch, seq_len, wave_len, steps_per_update)
    gan = bench_gan(cfg, device, gan_batch, gan_steps, warmup, seed)
    launches = read_counters(device, [])
    return {
        "backend": device.type,
        "devices": 1,
        "batch_size": batch,
        "steps_per_update": steps_per_update,
        "optimizer_steps_per_sec": acoustic["optimizer_steps_per_sec"],
        "examples_per_sec": acoustic["examples_per_sec"],
        "audio_seconds_trained_per_sec": acoustic["audio_seconds_trained_per_sec"],
        "final_loss": acoustic["final_loss"],
        "vocoder_gan": gan,
        "device": card_line(device),
        "seq_len": seq_len,
        "wave_len": wave_len,
        "iters": iters,
        "warmup": warmup,
        "runs_s": acoustic["runs"],
        "peak_memory_bytes": acoustic["peak_memory_bytes"],
        "launches": launches,
    }


def main(argv=None) -> int:
    p = parser("Training throughput of the port (scripts/bench_train.py's shapes)", UPDATES, WARMUP)
    return run_main("train", p.parse_args(argv), run)


if __name__ == "__main__":
    sys.exit(main())
