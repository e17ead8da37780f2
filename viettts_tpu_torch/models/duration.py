"""Phoneme duration model (counterpart of ``viettts_tpu/models/duration.py``):
TokenEncoder -> Linear -> gelu -> Linear(1) -> softplus, predicting
per-phoneme durations in seconds.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.config import DurationModelConfig
from viettts_tpu_torch.models.encoder import TokenEncoder
from viettts_tpu_torch.types import DurationBatch


class DurationModel(nn.Module):
    def __init__(self, cfg: DurationModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = TokenEncoder(cfg.vocab_size, cfg.lstm_dim)
        self.proj_0 = nn.Linear(2 * cfg.lstm_dim, cfg.lstm_dim)
        self.proj_1 = nn.Linear(cfg.lstm_dim, 1)

    def forward(self, batch: DurationBatch) -> torch.Tensor:
        """-> [B, T] durations in seconds."""
        x = self.encoder(batch.phonemes, batch.lengths)
        # jax.nn.gelu defaults to the tanh approximation
        x = F.gelu(self.proj_0(x), approximate="tanh")
        return F.softplus(self.proj_1(x).squeeze(-1))
