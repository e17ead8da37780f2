"""Shared trainer machinery (counterpart of ``viettts_tpu/train/common.py``):
the train state, the optimizer, the loss wrappers and the update step.

* The optimizer is optax's ``chain(clip_by_global_norm(max_norm),
  adamw(lr, weight_decay))`` written out over the parameter dict, with
  optax's arithmetic: gradients are scaled by ``max_norm / g_norm`` only
  when ``g_norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds
  1e-6 to the norm and scales always), bias-corrected moments,
  ``u = m_hat / (sqrt(v_hat) + 1e-8) + wd * p`` on every leaf, then
  ``p -= lr * u``; with ``max_grad_norm=None`` it is ``adamw`` alone, as
  the GAN trainer uses it.  Its state converts to and from optax's tree
  (``opt_state_to_optax`` / ``opt_state_from_optax``).
* ``mixed_precision_loss`` casts parameters and batch statistics to
  bfloat16 at the loss boundary, as the JAX package does (not
  ``torch.autocast``); the float32 masters get the gradients.
* ``make_update_fn`` takes ``steps_per_update`` optimizer steps a call
  and returns their mean loss.  Parameters and statistics are updated in
  place, so the modules they belong to always hold the current weights.

Under a process group (``parallel/mesh.py``) each rank holds its rows of
the global batch.  ``make_update_fn(..., data_parallel=True)`` runs the
loss inside ``mesh.data_parallel()`` (global BatchNorm statistics, global
dropout draws, global loss denominators), so each rank's loss is its
share of the global loss; the gradients are then summed over the ranks in
one flat bucket before the optimizer, whose clip sees the global norm as
optax's does under ``jit``, and the reported loss is summed too.
``FsdpClipAdamW`` (``train.fsdp``) keeps the large leaves' parameters and
moments sharded at rest, gathers the parameters for each step and
reduce-scatters their gradients instead of all-reducing.
``DistributedDataParallel`` is not used: the parameters are functional
dicts and the GAN step runs the discriminators twice.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from viettts_tpu_torch.checkpoint import (
    EmptyState,
    ScaleByAdamState,
    ScaleByScheduleState,
    jax_tree,
    named_from_jax,
)
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.data.loader import prefetch_to_device
from viettts_tpu_torch.parallel import mesh
from viettts_tpu_torch.utils.profiling import annotate

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]
# loss_fn(params, batch_stats, generator, batch) -> (loss, new_batch_stats)
LossFn = Callable[..., Tuple[torch.Tensor, Tensors]]


class AdamWState(NamedTuple):
    count: int  # optax ScaleByAdamState.count: updates taken
    mu: Tensors  # first moments, by parameter name
    nu: Tensors  # second moments
    schedule_count: Optional[int]  # ScaleByScheduleState.count; None at a constant rate


class TrainState(NamedTuple):
    step: int
    params: Tensors  # the model's parameters (float32 masters), by name
    batch_stats: Tensors  # its BatchNorm running statistics, by buffer name
    opt_state: AdamWState
    rng: torch.Generator


def exponential_decay(
    init_value: float, transition_steps: int, decay_rate: float, staircase: bool = False
) -> Schedule:
    """``optax.exponential_decay``: ``init * rate ** (count / steps)``, the
    exponent floored with ``staircase``, in float32."""

    def schedule(count: int) -> float:
        if count <= 0:
            return float(np.float32(init_value))
        p = np.float32(count) / np.float32(transition_steps)
        if staircase:
            p = np.floor(p)
        return float(np.float32(init_value) * np.power(np.float32(decay_rate), p))

    return schedule


class ClipAdamW:
    """Global-norm clipping (none with ``max_grad_norm=None``), then AdamW,
    over a dict of parameters."""

    def __init__(
        self,
        learning_rate: Union[float, Schedule],
        max_grad_norm: Optional[float] = 1.0,
        weight_decay: float = 1e-4,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.learning_rate = learning_rate
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tensors) -> AdamWState:
        zeros = {k: torch.zeros_like(p, memory_format=torch.contiguous_format) for k, p in params.items()}
        return AdamWState(
            count=0,
            mu=zeros,
            nu={k: torch.zeros_like(z) for k, z in zeros.items()},
            schedule_count=0 if callable(self.learning_rate) else None,
        )

    @torch.no_grad()
    def update(
        self, grads: Tensors, state: AdamWState, params: Tensors, g_norm: Optional[torch.Tensor] = None
    ) -> AdamWState:
        """Apply one step to ``params`` in place; returns the new state
        (its moment tensors updated in place too).  ``g_norm``: the clip's
        global norm when the caller computed it (FSDP), else ``grads``'."""
        b1, b2 = self.b1, self.b2
        if self.max_grad_norm is not None:
            if g_norm is None:
                g_norm = torch.stack([torch.sum(g * g) for g in grads.values()]).sum().sqrt()
            keep = g_norm < self.max_grad_norm
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        if state.schedule_count is None:
            step_size = -self.learning_rate
            schedule_count = None
        else:
            step_size = -self.learning_rate(state.schedule_count)
            schedule_count = state.schedule_count + 1
        for name, p in params.items():
            g = grads[name]
            if self.max_grad_norm is not None:
                g = torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.weight_decay * p
            p.copy_(p + step_size * u)
        return state._replace(count=count, schedule_count=schedule_count)


def make_optimizer(
    learning_rate: Union[float, Schedule], max_grad_norm: float = 1.0, weight_decay: float = 1e-4
) -> ClipAdamW:
    """The reference's optimizer chain: global-norm clip + AdamW."""
    return ClipAdamW(learning_rate, max_grad_norm, weight_decay)


class FsdpClipAdamW:
    """``inner`` (a ``ClipAdamW``) over FSDP shards, for ``train.fsdp``
    under a process group: JAX's ``shard_params_fsdp``.  Each leaf that
    ``mesh.fsdp_shard_axis`` splits keeps only this rank's slice between
    steps, of the parameter as of Adam's moments: ``init`` replaces the
    parameter's data (the module's own tensor) by its slice, so resident
    parameter and optimizer bytes fall by the world size on those leaves.
    A step ``gather``s the whole parameters into working buffers for the
    forward and backward, gets each split leaf's summed gradient by
    reduce-scatter, drops the buffers and updates this rank's slices.
    Every other leaf is all-reduced (one flat bucket) and updated whole on
    every rank.  The clip's global norm is the all-reduced sum of the
    slices' squares plus the replicated leaves' squares, counted once.
    Gradients are summed (the trainers' losses are each rank's share of the
    global loss).  ``whole_params`` / ``whole_opt_state`` gather the whole
    trees (validation, checkpoints); ``local`` cuts a whole leaf (a
    restored checkpoint's) to this rank's slice."""

    def __init__(self, inner: ClipAdamW, min_size: int = 2**16):
        self.inner, self.min_size = inner, min_size
        self.max_grad_norm = inner.max_grad_norm
        self.axes: Dict[str, Optional[int]] = {}  # by parameter name, from the whole shapes at init

    def init(self, params: Tensors) -> AdamWState:
        """Split ``params`` (whole, the modules' tensors) in place and
        return moments for the slices."""
        w = mesh.world()[1]
        self.axes = {k: mesh.fsdp_shard_axis(tuple(p.shape), w, self.min_size) for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                if self.axes[k] is not None:
                    p.data = mesh.shard_of(p.data, self.axes[k]).clone()
        return self.inner.init(params)

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf ``name`` (itself if replicated
        or not a parameter)."""
        a = self.axes.get(name)
        return whole if a is None else mesh.shard_of(whole, a)

    def gather(self, params: Tensors) -> Tensors:
        """The whole parameters (a collective: every rank calls it); the
        split leaves as new tensors that require gradients."""
        return {k: p if self.axes[k] is None else mesh.all_gather_shard(p.detach(), self.axes[k]).requires_grad_()
                for k, p in params.items()}

    def shard_state(self, state: AdamWState) -> AdamWState:
        """This rank's slices of whole moments (a restored checkpoint's)."""

        def cut(m):
            return {k: v if self.axes[k] is None else self.local(k, v).clone() for k, v in m.items()}

        return state._replace(mu=cut(state.mu), nu=cut(state.nu))

    def full_state(self, state: AdamWState) -> AdamWState:
        """The whole moments, gathered (a collective: every rank calls it)."""

        def whole(m):
            return {k: v if self.axes[k] is None else mesh.all_gather_shard(v, self.axes[k]) for k, v in m.items()}

        return state._replace(mu=whole(state.mu), nu=whole(state.nu))

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors) -> AdamWState:
        """One step from this rank's local gradients of the whole leaves,
        on the parameters at rest (slices and replicated leaves)."""
        axes = self.axes
        replicated = [k for k in params if axes[k] is None]
        g = dict(zip(replicated, mesh.all_reduce_grads([grads[k] for k in replicated])))
        for k, a in axes.items():
            if a is not None:
                g[k] = mesh.reduce_scatter_shard(grads[k], a)
        g_norm = None
        if self.max_grad_norm is not None:
            zero = next(iter(params.values())).new_zeros(())
            sharded = sum((torch.sum(g[k] * g[k]) for k in params if axes[k] is not None), zero)
            torch.distributed.all_reduce(sharded)
            g_norm = (sharded + sum((torch.sum(g[k] * g[k]) for k in replicated), zero)).sqrt()
        return self.inner.update({k: g[k] for k in params}, state, params, g_norm=g_norm)


def whole_params(optimizer, params: Tensors) -> Tensors:
    """``params`` whole: an ``FsdpClipAdamW`` gathers its slices (a
    collective: every rank calls it)."""
    return optimizer.gather(params) if isinstance(optimizer, FsdpClipAdamW) else params


def whole_opt_state(optimizer, state: AdamWState) -> AdamWState:
    """``state`` with whole moments: an ``FsdpClipAdamW`` gathers its
    shards (a collective: every rank calls it)."""
    return optimizer.full_state(state) if isinstance(optimizer, FsdpClipAdamW) else state


def _params_tree(named: Tensors) -> Any:
    return jax_tree(named)["params"]


def _params_named(tree: Any, names: Sequence[str]) -> Dict[str, np.ndarray]:
    return named_from_jax({"params": tree}, names)


def opt_state_to_optax(state: AdamWState, clipped: bool = True, to_tree=_params_tree) -> Tuple:
    """optax's tree of ``chain(clip_by_global_norm, adamw)`` (of ``adamw``
    alone when not ``clipped``), numpy leaves in the JAX layout
    (``checkpoint.JAX_GLOBALS`` pickles the classes under optax's names);
    ``to_tree`` lays the moments out as the parameters' tree."""
    lr_state = EmptyState() if state.schedule_count is None else ScaleByScheduleState(
        np.asarray(state.schedule_count, np.int32)
    )
    adam = ScaleByAdamState(np.asarray(state.count, np.int32), to_tree(state.mu), to_tree(state.nu))
    adamw = (adam, EmptyState(), lr_state)
    return (EmptyState(), adamw) if clipped else adamw


def opt_state_from_optax(tree: Tuple, params: Tensors, from_tree=_params_named) -> AdamWState:
    """The inverse of ``opt_state_to_optax`` (either tree), moments on
    ``params``' devices; ``from_tree(tree, names)`` -> numpy arrays by
    name."""
    adam, _, lr_state = tree[1] if isinstance(tree[0], EmptyState) else tree
    names = list(params)

    def moments(t):
        arrays = from_tree(t, names)
        return {k: torch.from_numpy(arrays[k]).to(params[k].device) for k in names}

    return AdamWState(
        count=int(adam.count),
        mu=moments(adam.mu),
        nu=moments(adam.nu),
        schedule_count=int(lr_state.count) if isinstance(lr_state, ScaleByScheduleState) else None,
    )


def opt_state_tree(state: AdamWState, leaf: Callable[[str, torch.Tensor], torch.Tensor] = lambda k, t: t) -> Dict:
    """``state`` as the sharded format's tree: ``{"mu", "nu", "count"}``,
    with ``"schedule_count"`` under a schedule; each moment through
    ``leaf(name, tensor)``.  The moments are ``state``'s own tensors, so
    loading into the tree restores them in place."""
    tree = {"mu": {k: leaf(k, v) for k, v in state.mu.items()}, "nu": {k: leaf(k, v) for k, v in state.nu.items()},
            "count": torch.tensor(state.count)}
    if state.schedule_count is not None:
        tree["schedule_count"] = torch.tensor(state.schedule_count)
    return tree


def opt_state_counts(tree: Dict, state: AdamWState) -> AdamWState:
    """``state`` with the counts of ``tree`` (an ``opt_state_tree`` loaded
    in place, its moments ``state``'s)."""
    schedule_count = tree.get("schedule_count")
    return state._replace(count=int(tree["count"]),
                          schedule_count=None if schedule_count is None else int(schedule_count))


def _cast(tree: Tensors, src: torch.dtype, dst: torch.dtype) -> Tensors:
    return {k: v.to(dst) if v.dtype == src else v for k, v in tree.items()}


def mixed_precision_loss(loss_fn: LossFn) -> LossFn:
    """bf16 mixed precision by casting at the loss boundary: parameters and
    statistics go in as bfloat16 (the cast is differentiable, so the
    float32 masters get float32 gradients), the updated statistics and the
    loss come back as float32."""

    def wrapped(params, batch_stats, generator, batch):
        loss, new_stats = loss_fn(
            _cast(params, torch.float32, torch.bfloat16),
            _cast(batch_stats, torch.float32, torch.bfloat16),
            generator,
            batch,
        )
        return loss.float(), _cast(new_stats, torch.bfloat16, torch.float32)

    return wrapped


def make_update_fn(
    loss_fn: LossFn, optimizer: Union[ClipAdamW, FsdpClipAdamW], data_parallel: bool = False
) -> Callable[[TrainState, Sequence[Any]], Tuple[TrainState, torch.Tensor]]:
    """``update(state, batches)``: one optimizer step per batch of
    ``batches`` (``steps_per_update`` of them); returns the new state and
    the mean loss, a tensor on the device (reading it waits for the
    device).  With ``data_parallel`` each batch is this rank's rows of a
    global batch: the loss runs inside ``mesh.data_parallel()``, the
    gradients and the reported loss are summed over the ranks (by an
    ``FsdpClipAdamW`` itself)."""
    fsdp = isinstance(optimizer, FsdpClipAdamW)
    if fsdp and not data_parallel:
        raise ValueError("FsdpClipAdamW needs data_parallel=True (a process group)")

    def one_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        names = list(state.params)
        params = optimizer.gather(state.params) if fsdp else state.params  # FSDP: whole working buffers
        with mesh.data_parallel() if data_parallel else contextlib.nullcontext():
            loss, new_stats = loss_fn(params, state.batch_stats, state.rng, batch)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        del params  # the working buffers go once the backward is done
        if data_parallel and not fsdp:
            grads = mesh.all_reduce_grads(grads)
        opt_state = optimizer.update(dict(zip(names, grads)), state.opt_state, state.params)
        with torch.no_grad():
            for k, v in new_stats.items():
                state.batch_stats[k].copy_(v)
        return state._replace(step=state.step + 1, opt_state=opt_state), loss.detach()

    def update(state: TrainState, batches: Sequence[Any]) -> Tuple[TrainState, torch.Tensor]:
        losses = []
        for batch in batches:
            state, loss = one_step(state, batch)
            losses.append(loss)
        loss = torch.stack(losses).mean()
        return state, mesh.all_reduce_value(loss) if data_parallel else loss

    return update


def init_train_state(
    params: Tensors,
    batch_stats: Tensors,
    optimizer: ClipAdamW,
    rng: torch.Generator,
    step: int = 0,
) -> TrainState:
    return TrainState(step, params, batch_stats, optimizer.init(params), rng)


class MetricAverager:
    """Mean of the last ``maxlen`` scalar losses (tensors are read only
    when the mean is asked for)."""

    def __init__(self, maxlen: int):
        self._dq = deque(maxlen=maxlen)

    def add(self, value) -> None:
        self._dq.append(value)

    def mean(self) -> float:
        if not self._dq:
            return float("nan")
        return sum(float(v) for v in self._dq) / len(self._dq)


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass --device cpu to train on the CPU"
        )
    return device


def run_steps(cfg: Config, state: TrainState, train_iter, device, update, step_log, on_interval) -> TrainState:
    """The trainers' loop: ``steps_per_update`` batches uploaded one update
    ahead, ``on_interval(state, step, steps_done, loss)`` after each update.
    With a ``step_log`` list each update waits for the device and appends
    (its seconds, its mean loss)."""
    spu = cfg.train.steps_per_update
    batches = prefetch_to_device(iter(lambda: [next(train_iter) for _ in range(spu)], None), device)
    start = step = state.step
    for steps_done in itertools.count(spu, spu):
        if step >= cfg.train.num_training_steps:
            break
        tick = time.perf_counter()
        with annotate("update"):
            state, loss = update(state, next(batches))
        if step_log is not None:
            step_log.append((time.perf_counter() - tick, float(loss)))
        step = start + steps_done
        on_interval(state, step, steps_done, loss)
    return state


def launch_device(device: str):
    """``device``, or under ``torchrun`` (its ``WORLD_SIZE`` set) this
    rank's device once the process group is joined
    (``mesh.initialize_distributed``: one process per device)."""
    if "WORLD_SIZE" not in os.environ:
        return device
    return mesh.initialize_distributed(device=device)


def parse_args(description: str, argv=None):
    """``--data-dir``, ``--ckpt-dir``, ``--set K=V`` and ``--device`` ->
    (config, device); under ``torchrun`` the device is this rank's."""
    from argparse import ArgumentParser

    from viettts_tpu_torch.config import apply_overrides

    parser = ArgumentParser(description=description)
    parser.add_argument("--data-dir", type=Path, default=None)
    parser.add_argument("--ckpt-dir", type=Path, default=None)
    parser.add_argument("--set", action="append", default=[], metavar="K=V")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu to train on the CPU)")
    args = parser.parse_args(argv)
    cfg = apply_overrides(Config(), args.set)
    if args.data_dir:
        cfg = cfg.replace(data_dir=args.data_dir)
    if args.ckpt_dir:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)
    Path(cfg.ckpt_dir).mkdir(parents=True, exist_ok=True)
    return cfg, launch_device(args.device)
