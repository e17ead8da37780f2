"""Plain reference of the three serving models, in PyTorch operations.

Written from the published descriptions, on the seeded numpy trees (the
JAX package's layout), one model module a model
(``perfbench/reference/models/``), which the configuration names; the
vocoder at the precision the configuration states for it
(``Reference.wave``).

The reference runs in float32 with TF32 off (``no_tf32``), or, as the
lower-precision control, under bfloat16 autocast.  It imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.harness.weights import TREES


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def precision(device: torch.device, dtype: str):
    """The context the reference computes in: float32 without TF32, or
    bfloat16 autocast (the control)."""
    if dtype == "float32":
        return no_tf32()
    if dtype == "bfloat16":
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
    raise ValueError(f"no reference precision {dtype!r}")


def _tensors(tree, device) -> dict:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


class Reference:
    """The three models of one seeded configuration on ``device``, each
    computed by its model module (``cells.Models``)."""

    def __init__(self, trees: dict, sizes: Dict[str, object], device: torch.device, models):
        self.sizes = sizes
        self.device = device
        self.models = models
        self.trees = {role: _tensors(trees[kind], device) for role, kind in TREES.items()}
        self.fps = sizes["dsp.sample_rate"] / sizes["dsp.hop_length"]

    @torch.no_grad()
    def durations(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Seconds [B, T], word ends and padding zeroed (no silence clamp)."""
        return self.models.duration.durations(self.trees["duration"], self.sizes, tokens, lengths)

    @torch.no_grad()
    def mel(self, tokens, lengths, frames, n_frames: int, keep1, keep2, keep_prob: float) -> torch.Tensor:
        """Log-mel [B, n_frames, D].  ``frames`` [B, T] are the durations in
        frames; ``keep1``/``keep2`` [n_frames, B, P] the prenet's keep masks."""
        return self.models.acoustic.mel(self.trees["acoustic"], self.sizes, tokens, lengths, frames, n_frames,
                                        keep1, keep2, keep_prob)

    @torch.no_grad()
    def wave(self, mel: torch.Tensor, dtype: Optional[str] = None) -> torch.Tensor:
        """Waveform [B, n_frames * hop] of a log-mel [B, n_frames, D], at the
        vocoder precision the configuration states
        (``hifigan.inference_dtype``); ``dtype`` overrides it."""
        return self.models.vocoder.wave(self.trees["vocoder"], self.sizes, mel,
                                        dtype or self.sizes["hifigan.inference_dtype"])


def keep_masks(seed: int, n_frames: int, rows: int, prenet_dim: int, keep_prob: float, device) -> List[torch.Tensor]:
    """The prenet's keep masks of one dispatch, drawn as the serving path
    draws them: a generator on the device seeded with the prenet seed, two
    uniform draws of [n_frames, rows, prenet_dim], kept below ``keep_prob``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (n_frames, rows, prenet_dim)
    return [torch.rand(shape, generator=gen, device=device) < keep_prob
            for _ in range(2)]
