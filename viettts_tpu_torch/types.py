"""Batch interchange types (counterpart of ``viettts_tpu/types.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DurationBatch(NamedTuple):
    """A batch for the duration model.

    phonemes:  [B, L] int64 token ids.
    lengths:   [B]    int64 true sequence lengths.
    durations: [B, L] float32 per-phoneme durations in seconds (None at
               inference).
    """

    phonemes: torch.Tensor
    lengths: torch.Tensor
    durations: Optional[torch.Tensor]
