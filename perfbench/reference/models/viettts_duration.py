"""vietTTS's duration model (``nat/model.py``): the token encoder, dense,
gelu (tanh form), dense to 1, softplus, in seconds.

Seeded as ``bench/seeded.py`` lays it out, but for the head: its bias at
-2.5, so that tokens last about 80 ms, and its kernel scaled by the
configuration's ``head_kernel_gain``, so that every seed speaks at about the
same pace and the work a seed asks for does not move with its weights.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.nn import functional as F

from perfbench.harness.weights import Leaf
from perfbench.reference.models import layers


def leaves(sizes: Dict[str, object], gains: Dict[str, float]) -> List[Leaf]:
    dd = sizes["duration.lstm_dim"]
    out = layers.encoder_leaves(sizes["duration.vocab_size"], dd)
    out += layers.dense_leaves(("params", "proj_0"), 2 * dd, dd)
    return out + [Leaf(("params", "proj_1", "kernel"), (dd, 1), gains["head_kernel_gain"] * dd ** -0.5),
                  Leaf(("params", "proj_1", "bias"), (1,), 0.0, -2.5)]


def durations(tree, sizes, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Seconds [B, T], word ends and padding zeroed (no silence clamp)."""
    p, s = tree["params"], tree["batch_stats"]
    x = layers.encoder(p["encoder"], s["encoder"], tokens, lengths)
    x = F.gelu(x @ p["proj_0"]["kernel"] + p["proj_0"]["bias"], approximate="tanh")
    d = F.softplus((x @ p["proj_1"]["kernel"] + p["proj_1"]["bias"])[..., 0]).float()
    mask = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
    return torch.where((tokens == 3) | ~mask, 0.0, d)


def flops(sizes, n_tokens, batch=1):
    """Operations for a row of ``n_tokens`` tokens (``utils/flops.py``'s
    ``duration_flops``)."""
    d = sizes["duration.lstm_dim"]
    return (layers.encoder_flops(n_tokens, d, batch) + layers.dense_flops(n_tokens, 2 * d, d, batch)
            + layers.dense_flops(n_tokens, d, 1, batch))
