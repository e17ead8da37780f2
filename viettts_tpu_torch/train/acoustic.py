"""Acoustic model trainer (counterpart of ``viettts_tpu/train/acoustic.py``).

    python -m viettts_tpu_torch.train.acoustic --data-dir CORPUS --ckpt-dir OUT [--set K=V ...] [--device cpu]

The reference's loss: log-mel targets computed on the device from the
silence-zeroed int16 waveforms, teacher forcing from a zero go frame,
durations from seconds to frames, ``0.5 * (MSE + MAE)`` over the outputs
before and after the postnet, over the frames below ``wav_lengths //
hop``.  ``steps_per_update > 1`` adds the staircase half-life of the
reference TPU trainer to the learning rate.  It runs on the card unless
given ``--device cpu``; the decoder is an eager loop over frames.

Data-parallel, one process per card (``train.batch_size`` stays the global
batch; ``train.fsdp=true`` keeps the large parameters and their moments
sharded at rest)::

    torchrun --nproc-per-node N -m viettts_tpu_torch.train.acoustic ... --set train.num_devices=N
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
from torch.func import functional_call

from viettts_tpu_torch.config import Config
from viettts_tpu_torch.data.loader import AcousticDataset, to_device
from viettts_tpu_torch.models.acoustic import AcousticModel
from viettts_tpu_torch.models.layers import batch_stats, batch_stats_update
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.parallel import mesh
from viettts_tpu_torch.train.checkpoint import check_format
from viettts_tpu_torch.train.common import (
    FsdpClipAdamW,
    MetricAverager,
    TrainState,
    exponential_decay,
    init_train_state,
    make_optimizer,
    make_update_fn,
    mixed_precision_loss,
    parse_args,
    resolve_device,
    run_steps,
    whole_params,
)
from viettts_tpu_torch.train.duration import restore_state, save_native_ckpt
from viettts_tpu_torch.types import AcousticBatch
from viettts_tpu_torch.utils.profiling import StepTimer, trace


def prepare_batch(batch: AcousticBatch, mel_fn: LogMelSpectrogram, hop: int):
    """Log-mels of the int16 waveforms, the decoder inputs (a zero go frame,
    then the targets shifted by one) and durations in frames.  Returns
    (model batch, target mels)."""
    mels = mel_fn(batch.wavs.float() / 2.0**15)  # [B, T, D]
    inp = torch.cat([torch.zeros_like(mels[:, :1]), mels[:, :-1]], dim=1)
    frames = batch.durations * mel_fn.cfg.sample_rate / hop
    return batch._replace(mels=inp, durations=frames), mels


def make_loss_fn(
    model: AcousticModel, mel_fn: LogMelSpectrogram, hop: int, train: bool, with_outputs: bool = False
):
    """loss(params, batch_stats, generator, batch) -> (loss, new_batch_stats),
    or (loss, (new_batch_stats, (mel after the postnet, target mels, the
    attention of row 0))) with ``with_outputs``."""

    def loss_fn(params, stats, generator, batch: AcousticBatch):
        model_batch, mels = prepare_batch(batch, mel_fn, hop)
        mel1, mel2, attn = functional_call(model, {**params, **stats}, (model_batch,), {"train": train, "generator": generator})
        new_stats = batch_stats_update(model) if train else stats
        sq = (torch.square(mel1 - mels) + torch.square(mel2 - mels)) / 2
        ab = (torch.abs(mel1 - mels) + torch.abs(mel2 - mels)) / 2
        per_frame = torch.mean((sq + ab) / 2, dim=-1)  # [B, T]
        T = mels.shape[1]
        mask = torch.arange(T, device=mels.device)[None, :] < (batch.wav_lengths // hop)[:, None]
        # over the global batch's frames under data parallelism
        loss = torch.sum(per_frame * mask) / torch.clamp(mesh.global_sum(torch.sum(mask)), min=1)
        if with_outputs:
            return loss, (new_stats, None if train else (mel2, mels, attn))
        return loss, new_stats

    return loss_fn


def _save_triptych(path: Path, snapshot) -> None:
    """Predicted mel / ground-truth mel / attention PNG; skipped without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    mel2_hat, mels, attn = (np.asarray(t.float().cpu()) for t in snapshot)
    plt.figure(figsize=(10, 10))
    for i, img in enumerate((mel2_hat[0], mels[0], attn)):
        plt.subplot(3, 1, i + 1)
        plt.imshow(img.T, origin="lower", aspect="auto")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def train(
    cfg: Config = Config(),
    save_plots: bool = True,
    device="cuda",
    step_log: Optional[List] = None,
) -> TrainState:
    tcfg = cfg.train
    check_format(tcfg.checkpoint_format)
    device = resolve_device(device)
    dp = mesh.check_data_parallel(tcfg.num_devices, tcfg.batch_size, tcfg.fsdp)
    main_rank = mesh.world()[0] == 0
    hop = cfg.dsp.hop_length
    model = AcousticModel(cfg.acoustic)
    model.init_params(torch.Generator().manual_seed(tcfg.seed))
    model.to(device)
    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    lr = tcfg.learning_rate
    if tcfg.steps_per_update > 1:  # the reference TPU trainer's half-life
        lr = exponential_decay(lr, 50_000, 0.5, staircase=True)
    optimizer = make_optimizer(lr, tcfg.max_grad_norm, tcfg.weight_decay)
    if tcfg.fsdp:
        optimizer = FsdpClipAdamW(optimizer)

    def dataset(mode):
        return AcousticDataset(
            cfg.data_dir, cfg.data.max_phoneme_seq_len, cfg.data.max_wave_len, mode, cfg.data, cfg.dsp.sample_rate
        )

    train_ds, val_ds = dataset("train"), dataset("val")
    train_iter = train_ds.batches(tcfg.batch_size, seed=tcfg.seed)
    val_iter = val_ds.batches(min(tcfg.batch_size, len(val_ds)), seed=0)
    next(train_iter)  # the JAX trainer initialises its variables on this batch
    if dp:  # every rank draws the global batch and keeps its rows
        train_iter = map(mesh.shard_batch, train_iter)

    rng = torch.Generator(device).manual_seed(tcfg.seed)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), optimizer, rng)
    ckpt_path = Path(cfg.ckpt_dir) / "acoustic_latest_ckpt.pickle"
    restored = restore_state(ckpt_path, optimizer, state, tcfg.checkpoint_format)
    if restored is not None:
        if main_rank:
            print(f"Resuming from {ckpt_path} at step {restored.step}")
        state = restored

    train_loss = make_loss_fn(model, mel_fn, hop, train=True)
    if tcfg.mixed_precision:
        train_loss = mixed_precision_loss(train_loss)
    update = make_update_fn(train_loss, optimizer, data_parallel=dp)
    val_fn = make_loss_fn(model, mel_fn, hop, train=False, with_outputs=True)
    train_avg, val_avg = MetricAverager(1000), MetricAverager(100)
    spu = tcfg.steps_per_update
    timer = StepTimer(device)
    val_snapshot = None

    def save(state):
        save_native_ckpt(ckpt_path, state, tcfg.checkpoint_format, optimizer)

    @torch.no_grad()
    def on_interval(state, step, steps_done, loss):
        nonlocal val_snapshot
        train_avg.add(loss)
        timer.tick(spu)
        if step % tcfg.val_interval < spu:  # the whole validation batch on every rank
            vb = to_device(next(val_iter), device)
            params = whole_params(optimizer, state.params)  # FSDP: a collective, on every rank
            vloss, (_, val_snapshot) = val_fn(params, state.batch_stats, state.rng, vb)
            val_avg.add(vloss)
        if step % tcfg.ckpt_interval < spu:
            if main_rank:
                print(f"step {step:>7d} | train {train_avg.mean():.4f} | val {val_avg.mean():.4f} | "
                      f"{timer.steps_per_sec():.2f} steps/s")
            save(state)
            if save_plots and main_rank and val_snapshot is not None:
                _save_triptych(Path(cfg.ckpt_dir) / f"mel_{step:06d}.png", val_snapshot)

    with trace():  # a device trace when VIETTTS_PROFILE_DIR is set
        state = run_steps(cfg, state, train_iter, device, update, step_log, on_interval)
    save(state)
    return state


def main(argv=None):
    cfg, device = parse_args("Train the acoustic model", argv)
    train(cfg, device=device)


if __name__ == "__main__":
    main()
