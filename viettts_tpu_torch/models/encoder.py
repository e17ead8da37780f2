"""Shared phoneme/text encoder (counterpart of
``viettts_tpu/models/encoder.py``): embedding -> 3 x [Conv1D(k=3, SAME) +
BatchNorm + relu + dropout] -> bidirectional LSTM with end-of-sequence
reset on the backward direction.  With ``train=False`` BatchNorm runs on
its running statistics and dropout is off; with ``train=True`` both follow
flax (``models/layers.py``), the dropout drawn from the caller's
generator.  Public tensors are channels-last.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.models.layers import BatchNorm, dropout, init_batch_norm_, init_conv_
from viettts_tpu_torch.ops.rnn import LSTM, bidirectional_lstm


class TokenEncoder(nn.Module):
    """Embed + conv stack + bi-LSTM.  Output dim = 2 * lstm_dim."""

    def __init__(self, vocab_size: int, lstm_dim: int, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.embed = nn.Embedding(vocab_size, lstm_dim)
        self.convs = nn.ModuleList(
            nn.Conv1d(lstm_dim, lstm_dim, 3, padding=1) for _ in range(3)
        )
        self.bns = nn.ModuleList(BatchNorm(lstm_dim) for _ in range(3))
        self.lstm_fwd = LSTM(lstm_dim, lstm_dim)
        self.lstm_bwd = LSTM(lstm_dim, lstm_dim)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """flax's initialisers: ``nn.Embed`` normal with variance
        1/lstm_dim, lecun-normal convs, unit BatchNorm, the JAX LSTM init."""
        self.embed.weight.normal_(0.0, self.embed.weight.shape[1] ** -0.5, generator=generator)
        for conv, bn in zip(self.convs, self.bns):
            init_conv_(conv, generator)
            init_batch_norm_(bn)
        self.lstm_fwd.init_params(generator)
        self.lstm_bwd.init_params(generator)

    def forward(
        self,
        phonemes: torch.Tensor,
        lengths: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """[B, T] token ids, [B] lengths -> [B, T, 2 * lstm_dim]."""
        x = self.embed(phonemes).transpose(1, 2)  # [B, C, T]
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x), train=train))
            if train:
                x = dropout(x, self.dropout_rate, generator)
        return bidirectional_lstm(
            self.lstm_fwd, self.lstm_bwd, x.transpose(1, 2), lengths
        )
