"""Duration model trainer (counterpart of ``viettts_tpu/train/duration.py``).

    python -m viettts_tpu_torch.train.duration --data-dir CORPUS --ckpt-dir OUT [--set K=V ...] [--device cpu]

The reference's loss and schedule: 10% of tokens masked to the word-end
token, masked L1 over real tokens other than word ends, clip + AdamW,
validation every ``val_interval`` steps and a resumable checkpoint every
``ckpt_interval``.  It runs on the card unless given ``--device cpu``.

Data-parallel, one process per card (``train.batch_size`` stays the global
batch; ``train.fsdp=true`` keeps the large parameters and their moments
sharded at rest)::

    torchrun --nproc-per-node N -m viettts_tpu_torch.train.duration ... --set train.num_devices=N
"""

from __future__ import annotations

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
from viettts_tpu_torch.parallel import mesh
from viettts_tpu_torch.train.checkpoint import (
    check_format,
    generator_state,
    jax_key,
    load_checkpoint,
    load_sharded,
    restore_generator,
    save_checkpoint,
    save_sharded,
    shard_leaf,
    sharded_dir,
)
from viettts_tpu_torch.train.common import (
    FsdpClipAdamW,
    MetricAverager,
    TrainState,
    init_train_state,
    make_optimizer,
    make_update_fn,
    mixed_precision_loss,
    opt_state_counts,
    opt_state_from_optax,
    opt_state_to_optax,
    opt_state_tree,
    parse_args,
    resolve_device,
    run_steps,
    whole_opt_state,
    whole_params,
)
from viettts_tpu_torch.types import DurationBatch
from viettts_tpu_torch.utils.profiling import StepTimer, trace


def make_loss_fn(model: DurationModel, token_mask_prob: float, train: bool):
    """loss(params, batch_stats, generator, batch) -> (loss, new_batch_stats)."""

    def loss_fn(params, stats, generator, batch: DurationBatch):
        phonemes = batch.phonemes
        if train and token_mask_prob > 0:
            m = mesh.rand_rows(phonemes.shape, generator, phonemes.device) < token_mask_prob
            phonemes = torch.where(m, WORD_END_INDEX, phonemes)
            batch = batch._replace(phonemes=phonemes)
        durations = functional_call(model, {**params, **stats}, (batch,), {"train": train, "generator": generator})
        new_stats = batch_stats_update(model) if train else stats
        L = phonemes.shape[1]
        mask = torch.arange(L, device=phonemes.device)[None, :] < batch.lengths[:, None]
        mask = mask & (phonemes != WORD_END_INDEX)
        masked_l1 = torch.abs(durations - batch.durations) * mask
        # over the global batch's tokens under data parallelism
        return torch.sum(masked_l1) / torch.clamp(mesh.global_sum(torch.sum(mask)), min=1), new_stats

    return loss_fn


def _sharded_tree(state: TrainState, optimizer) -> dict:
    """The sharded format's tree, JAX's ``{step, variables: {params,
    batch_stats}, opt_state, rng}`` with ``torch_rng`` beside it: the
    parameters and moments of the leaves an FSDP ``optimizer`` splits as
    this rank's slices (``shard_leaf``), every other tensor whole.  The
    tensors are ``state``'s own, so loading into the tree restores
    ``state`` in place."""
    axes = optimizer.axes if isinstance(optimizer, FsdpClipAdamW) else {}

    def leaf(name, t):
        return shard_leaf(t.detach(), axes.get(name))

    return {
        "step": torch.tensor(int(state.step)),
        "variables": {"params": {k: leaf(k, p) for k, p in state.params.items()},
                      "batch_stats": dict(state.batch_stats)},
        "opt_state": opt_state_tree(state.opt_state, leaf),
        "rng": torch.from_numpy(jax_key(state.rng).astype(np.int64)),
        "torch_rng": generator_state(state.rng),
    }


def save_native_ckpt(path: Path, state: TrainState, fmt: str = "pickle", optimizer=None) -> None:
    """Write a resumable training checkpoint.  ``fmt="pickle"``: one
    atomic pickle in the JAX package's native format
    (``train/checkpoint.py``); under a process group every rank calls it
    (an FSDP ``optimizer`` gathers the split leaves) and rank 0 writes.
    ``fmt="orbax"``: the sharded directory ``sharded_dir(path)`` and no
    pickle; under a group every rank calls it and writes its own slices,
    with no gather."""
    check_format(fmt)
    if fmt == "orbax":
        save_sharded(sharded_dir(path), _sharded_tree(state, optimizer))
        return
    params = whole_params(optimizer, state.params)
    opt_state = whole_opt_state(optimizer, state.opt_state)
    if mesh.world()[0] != 0:
        return
    variables = {**jax_tree(params), **jax_tree(state.batch_stats)}
    save_checkpoint(
        path,
        {
            "format": NATIVE_FORMAT,
            "step": int(state.step),
            "variables": {"params": variables["params"], "batch_stats": variables["batch_stats"]},
            "opt_state": opt_state_to_optax(opt_state),
            "rng": jax_key(state.rng),
            "torch_rng": generator_state(state.rng),
        },
    )


def restore_state(path: Path, optimizer, template: TrainState, fmt: str = "pickle") -> Optional[TrainState]:
    """Resume from a checkpoint: parameters and statistics go into
    ``template``'s tensors (the model's own), moments onto their devices
    (this rank's slices of the split leaves for an FSDP ``optimizer``,
    whose ``init`` has split ``template``'s).  ``fmt="pickle"``: a native
    pickle written by the port or the JAX package; ``fmt="orbax"``: the
    port's sharded directory, written under any number of ranks, FSDP on or
    off, resharded to this run's layout.  None when there is no such
    checkpoint.  Every rank reads it."""
    check_format(fmt)
    if fmt == "orbax":
        tree = load_sharded(sharded_dir(path), _sharded_tree(template, optimizer))
        if tree is None:
            return None
        restore_generator(template.rng, {"torch_rng": tree["torch_rng"], "rng": tree["rng"].numpy()})
        return template._replace(step=int(tree["step"]),
                                 opt_state=opt_state_counts(tree["opt_state"], template.opt_state))
    dic = load_checkpoint(path)
    if dic is None or dic.get("format") != NATIVE_FORMAT:
        return None
    fsdp = isinstance(optimizer, FsdpClipAdamW)
    tensors = {**template.params, **template.batch_stats}
    with torch.no_grad():
        for name, a in named_from_jax(dic["variables"], list(tensors)).items():
            whole = torch.from_numpy(a)
            tensors[name].copy_(optimizer.local(name, whole) if fsdp else whole)
    restore_generator(template.rng, dic)
    opt_state = opt_state_from_optax(dic["opt_state"], template.params)
    if fsdp:
        opt_state = optimizer.shard_state(opt_state)
    return template._replace(step=int(dic["step"]), opt_state=opt_state)


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
    device = resolve_device(device)
    dp = mesh.check_data_parallel(tcfg.num_devices, tcfg.batch_size, tcfg.fsdp)
    main_rank = mesh.world()[0] == 0
    model = DurationModel(cfg.duration)
    model.init_params(torch.Generator().manual_seed(tcfg.seed))
    model.to(device)
    optimizer = make_optimizer(tcfg.duration_learning_rate, tcfg.max_grad_norm, tcfg.weight_decay)
    if tcfg.fsdp:
        optimizer = FsdpClipAdamW(optimizer)

    train_ds = DurationDataset(cfg.data_dir, cfg.data.max_phoneme_seq_len, "train", cfg.data)
    val_ds = DurationDataset(cfg.data_dir, cfg.data.max_phoneme_seq_len, "val", cfg.data)
    train_iter = train_ds.batches(tcfg.batch_size, seed=tcfg.seed)
    val_iter = val_ds.batches(min(tcfg.batch_size, len(val_ds)), seed=0)
    next(train_iter)  # the JAX trainer initialises its variables on this batch
    if dp:  # every rank draws the global batch and keeps its rows
        train_iter = map(mesh.shard_batch, train_iter)

    rng = torch.Generator(device).manual_seed(tcfg.seed)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), optimizer, rng)
    ckpt_path = Path(cfg.ckpt_dir) / "duration_latest_ckpt.pickle"
    restored = restore_state(ckpt_path, optimizer, state, tcfg.checkpoint_format)
    if restored is not None:
        if main_rank:
            print(f"Resuming from {ckpt_path} at step {restored.step}")
        state = restored

    train_loss = make_loss_fn(model, tcfg.token_mask_prob, train=True)
    if tcfg.mixed_precision:
        train_loss = mixed_precision_loss(train_loss)
    update = make_update_fn(train_loss, optimizer, data_parallel=dp)
    val_loss = make_loss_fn(model, 0.0, train=False)
    train_avg, val_avg = MetricAverager(1000), MetricAverager(100)
    spu = tcfg.steps_per_update
    timer = StepTimer(device)

    def save(state):
        save_native_ckpt(ckpt_path, state, tcfg.checkpoint_format, optimizer)

    @torch.no_grad()
    def on_interval(state, step, steps_done, loss):
        train_avg.add(loss)
        timer.tick(spu)
        val_due, ckpt_due = step % tcfg.val_interval < spu, step % tcfg.ckpt_interval < spu
        if val_due or (ckpt_due and save_plots):  # FSDP: a collective, on every rank
            params = whole_params(optimizer, state.params)
        if val_due:  # the whole validation batch on every rank
            vb = to_device(next(val_iter), device)
            val_avg.add(val_loss(params, state.batch_stats, state.rng, vb)[0])
        if ckpt_due:
            if main_rank:
                print(f"step {step:>7d} | train {train_avg.mean():.5f} | val {val_avg.mean():.5f} | "
                      f"{timer.steps_per_sec():.1f} steps/s")
            save(state)
            if save_plots and main_rank:
                vb = to_device(next(val_iter), device)
                pred = functional_call(model, {**params, **state.batch_stats}, (vb,), {"train": False})
                _save_duration_plot(
                    Path(cfg.ckpt_dir) / f"duration_{step:06d}.png",
                    pred[0].cpu(), vb.durations[0].cpu(), int(vb.lengths[0]),
                )

    with trace():  # a device trace when VIETTTS_PROFILE_DIR is set
        state = run_steps(cfg, state, train_iter, device, update, step_log, on_interval)
    save(state)
    return state


def main(argv=None):
    cfg, device = parse_args("Train the duration model", argv)
    train(cfg, device=device)


if __name__ == "__main__":
    main()
