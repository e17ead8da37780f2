"""Shared phoneme/text encoder (counterpart of
``viettts_tpu/models/encoder.py``): embedding -> 3 x [Conv1D(k=3, SAME) +
BatchNorm + relu] -> bidirectional LSTM with end-of-sequence reset on the
backward direction.  Inference only: BatchNorm runs on its running
statistics and dropout is off.  Public tensors are channels-last.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.ops.rnn import LSTM, bidirectional_lstm


class TokenEncoder(nn.Module):
    """Embed + conv stack + bi-LSTM.  Output dim = 2 * lstm_dim."""

    def __init__(self, vocab_size: int, lstm_dim: int):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, lstm_dim)
        self.convs = nn.ModuleList(
            nn.Conv1d(lstm_dim, lstm_dim, 3, padding=1) for _ in range(3)
        )
        self.bns = nn.ModuleList(
            nn.BatchNorm1d(lstm_dim, eps=1e-5) for _ in range(3)
        )
        self.lstm_fwd = LSTM(lstm_dim, lstm_dim)
        self.lstm_bwd = LSTM(lstm_dim, lstm_dim)

    def forward(self, phonemes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """[B, T] token ids, [B] lengths -> [B, T, 2 * lstm_dim]."""
        x = self.embed(phonemes).transpose(1, 2)  # [B, C, T]
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        return bidirectional_lstm(
            self.lstm_fwd, self.lstm_bwd, x.transpose(1, 2), lengths
        )
