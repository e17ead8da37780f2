"""Phoneme duration model (counterpart of ``viettts_tpu/models/duration.py``):
TokenEncoder -> Linear -> gelu -> Linear(1) -> softplus, predicting
per-phoneme durations in seconds.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.config import DurationModelConfig
from viettts_tpu_torch.models.encoder import TokenEncoder
from viettts_tpu_torch.models.layers import lecun_normal_
from viettts_tpu_torch.types import DurationBatch


class DurationModel(nn.Module):
    def __init__(self, cfg: DurationModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TokenEncoder(cfg.vocab_size, cfg.lstm_dim, cfg.dropout_rate)
        self.proj_0 = nn.Linear(2 * cfg.lstm_dim, cfg.lstm_dim)
        self.proj_1 = nn.Linear(cfg.lstm_dim, 1)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """flax's initialisers (``nn.Dense``: lecun-normal kernel, zero bias)."""
        self.encoder.init_params(generator)
        for linear in (self.proj_0, self.proj_1):
            lecun_normal_(linear.weight, linear.weight.shape[1], generator)
            linear.bias.zero_()

    def forward(
        self, batch: DurationBatch, *, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """-> [B, T] durations in seconds."""
        x = self.encoder(batch.phonemes, batch.lengths, train=train, generator=generator)
        # jax.nn.gelu defaults to the tanh approximation
        x = F.gelu(self.proj_0(x), approximate="tanh")
        return F.softplus(self.proj_1(x).squeeze(-1))
