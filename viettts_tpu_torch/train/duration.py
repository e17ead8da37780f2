"""Duration model trainer (counterpart of ``viettts_tpu/train/duration.py``).

    python -m viettts_tpu_torch.train.duration --data-dir CORPUS --ckpt-dir OUT [--set K=V ...] [--device cpu]

The reference's loss and schedule: 10% of tokens masked to the word-end
token, masked L1 over real tokens other than word ends, clip + AdamW,
validation every ``val_interval`` steps and a resumable checkpoint every
``ckpt_interval``.  It runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
from torch.func import functional_call

from viettts_tpu_torch.checkpoint import NATIVE_FORMAT, jax_tree, named_from_jax
from viettts_tpu_torch.config import WORD_END_INDEX, Config
from viettts_tpu_torch.data.loader import DurationDataset, to_device
from viettts_tpu_torch.models.duration import DurationModel
from viettts_tpu_torch.models.layers import batch_stats, batch_stats_update
from viettts_tpu_torch.train.checkpoint import (
    check_format,
    generator_state,
    jax_key,
    load_checkpoint,
    restore_generator,
    save_checkpoint,
)
from viettts_tpu_torch.train.common import (
    MetricAverager,
    TrainState,
    init_train_state,
    make_optimizer,
    make_update_fn,
    mixed_precision_loss,
    opt_state_from_optax,
    opt_state_to_optax,
    parse_args,
    resolve_device,
    run_steps,
)
from viettts_tpu_torch.types import DurationBatch


def make_loss_fn(model: DurationModel, token_mask_prob: float, train: bool):
    """loss(params, batch_stats, generator, batch) -> (loss, new_batch_stats)."""

    def loss_fn(params, stats, generator, batch: DurationBatch):
        phonemes = batch.phonemes
        if train and token_mask_prob > 0:
            m = torch.rand(phonemes.shape, generator=generator, device=phonemes.device) < token_mask_prob
            phonemes = torch.where(m, WORD_END_INDEX, phonemes)
            batch = batch._replace(phonemes=phonemes)
        durations = functional_call(model, {**params, **stats}, (batch,), {"train": train, "generator": generator})
        new_stats = batch_stats_update(model) if train else stats
        L = phonemes.shape[1]
        mask = torch.arange(L, device=phonemes.device)[None, :] < batch.lengths[:, None]
        mask = mask & (phonemes != WORD_END_INDEX)
        masked_l1 = torch.abs(durations - batch.durations) * mask
        return torch.sum(masked_l1) / torch.clamp(torch.sum(mask), min=1), new_stats

    return loss_fn


def save_native_ckpt(path: Path, state: TrainState, fmt: str = "pickle") -> None:
    """Write a resumable training checkpoint (one atomic pickle in the JAX
    package's native format, ``train/checkpoint.py``)."""
    check_format(fmt)
    variables = {**jax_tree(state.params), **jax_tree(state.batch_stats)}
    save_checkpoint(
        path,
        {
            "format": NATIVE_FORMAT,
            "step": int(state.step),
            "variables": {"params": variables["params"], "batch_stats": variables["batch_stats"]},
            "opt_state": opt_state_to_optax(state.opt_state),
            "rng": jax_key(state.rng),
            "torch_rng": generator_state(state.rng),
        },
    )


def restore_state(path: Path, optimizer, template: TrainState, fmt: str = "pickle") -> Optional[TrainState]:
    """Resume from a native checkpoint written by the port or the JAX
    package: parameters and statistics are copied into ``template``'s
    tensors (the model's own), moments onto their devices.  None when
    ``path`` holds no native checkpoint."""
    check_format(fmt)
    dic = load_checkpoint(path)
    if dic is None or dic.get("format") != NATIVE_FORMAT:
        return None
    tensors = {**template.params, **template.batch_stats}
    with torch.no_grad():
        for name, a in named_from_jax(dic["variables"], list(tensors)).items():
            tensors[name].copy_(torch.from_numpy(a))
    restore_generator(template.rng, dic)
    return template._replace(
        step=int(dic["step"]), opt_state=opt_state_from_optax(dic["opt_state"], template.params)
    )


def _save_duration_plot(path: Path, predicted, target, length: int) -> None:
    """Predicted-vs-ground-truth duration curves PNG; skipped without
    matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    plt.figure()
    plt.plot(np.asarray(predicted)[:length])
    plt.plot(np.asarray(target)[:length])
    plt.legend(["predicted", "gt"])
    plt.title("Phoneme durations")
    plt.savefig(path)
    plt.close()


def train(
    cfg: Config = Config(),
    save_plots: bool = False,
    device="cuda",
    step_log: Optional[List] = None,
) -> TrainState:
    tcfg = cfg.train
    check_format(tcfg.checkpoint_format)
    device = resolve_device(device)
    model = DurationModel(cfg.duration)
    model.init_params(torch.Generator().manual_seed(tcfg.seed))
    model.to(device)
    optimizer = make_optimizer(tcfg.duration_learning_rate, tcfg.max_grad_norm, tcfg.weight_decay)

    train_ds = DurationDataset(cfg.data_dir, cfg.data.max_phoneme_seq_len, "train", cfg.data)
    val_ds = DurationDataset(cfg.data_dir, cfg.data.max_phoneme_seq_len, "val", cfg.data)
    train_iter = train_ds.batches(tcfg.batch_size, seed=tcfg.seed)
    val_iter = val_ds.batches(min(tcfg.batch_size, len(val_ds)), seed=0)
    next(train_iter)  # the JAX trainer initialises its variables on this batch

    rng = torch.Generator(device).manual_seed(tcfg.seed)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), optimizer, rng)
    ckpt_path = Path(cfg.ckpt_dir) / "duration_latest_ckpt.pickle"
    restored = restore_state(ckpt_path, optimizer, state, tcfg.checkpoint_format)
    if restored is not None:
        print(f"Resuming from {ckpt_path} at step {restored.step}")
        state = restored

    train_loss = make_loss_fn(model, tcfg.token_mask_prob, train=True)
    if tcfg.mixed_precision:
        train_loss = mixed_precision_loss(train_loss)
    update = make_update_fn(train_loss, optimizer)
    val_loss = make_loss_fn(model, 0.0, train=False)
    train_avg, val_avg = MetricAverager(1000), MetricAverager(100)
    spu = tcfg.steps_per_update
    t0 = time.time()

    @torch.no_grad()
    def on_interval(state, step, steps_done, loss):
        train_avg.add(loss)
        if step % tcfg.val_interval < spu:
            vb = to_device(next(val_iter), device)
            val_avg.add(val_loss(state.params, state.batch_stats, state.rng, vb)[0])
        if step % tcfg.ckpt_interval < spu:
            sps = steps_done / max(time.time() - t0, 1e-6)
            print(f"step {step:>7d} | train {train_avg.mean():.5f} | val {val_avg.mean():.5f} | {sps:.1f} steps/s")
            save_native_ckpt(ckpt_path, state, tcfg.checkpoint_format)
            if save_plots:
                vb = to_device(next(val_iter), device)
                pred = model(vb, train=False)
                _save_duration_plot(
                    Path(cfg.ckpt_dir) / f"duration_{step:06d}.png",
                    pred[0].cpu(), vb.durations[0].cpu(), int(vb.lengths[0]),
                )

    state = run_steps(cfg, state, train_iter, device, update, step_log, on_interval)
    save_native_ckpt(ckpt_path, state, tcfg.checkpoint_format)
    return state


def main(argv=None):
    cfg, device = parse_args("Train the duration model", argv)
    train(cfg, device=device)


if __name__ == "__main__":
    main()
