"""Batch interchange types (counterpart of ``viettts_tpu/types.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DurationBatch(NamedTuple):
    """A batch for the duration model.

    phonemes:  [B, L] int token ids.
    lengths:   [B]    int true sequence lengths.
    durations: [B, L] float32 per-phoneme durations in seconds (None at
               inference).
    """

    phonemes: torch.Tensor
    lengths: torch.Tensor
    durations: Optional[torch.Tensor]


class AcousticBatch(NamedTuple):
    """A batch for the acoustic model.

    phonemes:    [B, L]  int token ids.
    lengths:     [B]     int true phoneme sequence lengths.
    durations:   [B, L]  float32 durations (seconds from the loader; the
                 trainer converts to frames before the model sees them).
    wavs:        [B, S]  int16 waveforms (silence-zeroed, padded).
    wav_lengths: [B]     int true waveform lengths in samples.
    mels:        [B, T, D] float32 log-mel decoder inputs (None until the
                 trainer computes them on the device).

    The loaders yield numpy leaves; ``data.loader.to_device`` uploads them.
    """

    phonemes: torch.Tensor
    lengths: torch.Tensor
    durations: torch.Tensor
    wavs: torch.Tensor
    wav_lengths: torch.Tensor
    mels: Optional[torch.Tensor]
