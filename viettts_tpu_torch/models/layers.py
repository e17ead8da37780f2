"""Training-mode building blocks shared by the port's models: flax's
BatchNorm, flax's dropout drawn from an explicit ``torch.Generator``, and
flax's parameter initialisers.

``nn.BatchNorm1d`` cannot stand in for flax's ``nn.BatchNorm`` in
training: it updates the running variance with the unbiased batch
variance and the running average with weight ``momentum`` on the batch.
Flax keeps ``0.9 * running + 0.1 * batch`` with the biased variance
``E[x^2] - E[x]^2`` (clipped at 0), over every position of the batch,
padding included.

Under ``parallel.mesh.data_parallel()`` a training forward sees this
rank's rows of a global batch: ``BatchNorm`` all-reduces its moment sums,
through autograd, so its statistics and gradients are the global batch's
as under JAX's ``jit``, and ``dropout`` draws at the global batch shape
and keeps this rank's rows.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.parallel.mesh import batch_rows, global_sum, rand_rows

# flax's truncated normal initialisers divide the standard deviation by the
# std of a unit normal truncated at +-2 (jax.nn.initializers.variance_scaling)
TRUNCATED_NORMAL_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """BatchNorm over channels-first [B, C, T] with flax's semantics.

    Inference (``train=False``) normalizes with the running statistics, as
    ``nn.BatchNorm1d.eval()`` does.  Training normalizes with the batch
    statistics and leaves the updated running statistics, detached, in
    ``new_stats`` for the caller to collect (``batch_stats_update``);
    the buffers themselves do not change, so a loss stays a function of
    (parameters, statistics, batch)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.new_stats = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        # statistics in at least float32, as flax computes them
        xf = x.float()
        rows = batch_rows()
        if rows is None:
            mean, mean_sq = xf.mean(dim=(0, 2)), (xf * xf).mean(dim=(0, 2))
        else:  # the global batch's moments: sums over every rank's rows
            sums = global_sum(torch.stack([xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))]))
            mean, mean_sq = sums / (xf.shape[0] * xf.shape[2] * rows.world)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        m = self.momentum
        self.new_stats = (
            (m * self.running_mean + (1 - m) * mean).detach(),
            (m * self.running_var + (1 - m) * var).detach(),
        )
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None]) * mul[:, None] + self.bias[:, None]
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's dropout: keep with probability ``1 - rate`` (a uniform draw
    from ``generator`` below it), scale kept values by ``1 / (1 - rate)``.
    Rate 0 returns ``x`` and draws nothing.  The batch is axis 0."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = rand_rows(x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of both, as JAX promotes a float32
    activation times a bfloat16 weight (mixed precision)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def conv1d(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` in the promoted dtype of input and weights."""
    dt = torch.promote_types(x.dtype, conv.weight.dtype)
    return F.conv1d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt), conv.stride, conv.padding, conv.dilation)


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std^2) truncated at +-2 std (``std * jax.random.truncated_normal(-2, 2)``)."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel initialiser: variance 1/fan_in after
    truncation at +-2 standard deviations."""
    return truncated_normal_(t, math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD, generator)


@torch.no_grad()
def init_conv_(conv: nn.Conv1d, generator: torch.Generator) -> None:
    """flax ``nn.Conv``: lecun-normal kernel (fan_in = taps x C_in), zero bias."""
    lecun_normal_(conv.weight, conv.weight.shape[1] * conv.weight.shape[2], generator)
    conv.bias.zero_()


@torch.no_grad()
def init_batch_norm_(bn: BatchNorm) -> None:
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics of every ``BatchNorm`` of ``model``, by
    buffer name."""
    return {
        f"{name}.{stat}": getattr(m, stat)
        for name, m in model.named_modules()
        if isinstance(m, BatchNorm)
        for stat in ("running_mean", "running_var")
    }


def batch_stats_update(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics the last training forward left in each
    ``BatchNorm`` (``new_stats``), by buffer name; each is cleared."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            if m.new_stats is None:
                raise RuntimeError(f"BatchNorm {name} ran no training forward")
            out[f"{name}.running_mean"], out[f"{name}.running_var"] = m.new_stats
            m.new_stats = None
    return out
