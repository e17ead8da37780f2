"""HiFi-GAN generator, inference only (counterpart of the ``Generator`` and
the fused serving path in ``viettts_tpu/models/hifigan.py``).

Mel [B, T, n_mels] -> conv_pre -> 4 stages of [leaky_relu ->
ConvTranspose(stride u, SAME) -> mean of the multi-receptive-field
resblocks] -> leaky_relu(0.01) -> conv_post -> tanh: [B, T * 256, 1].

``Generator.forward`` is the plain float32 formulation with torch convs.
``generator_apply_fused`` is the serving path: every stage, ConvTranspose
prologue included and the tail fused into the last one, goes through
``fused_mrf`` (kernel K2 on CUDA), with float32 or bfloat16 storage.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.config import HifiGanConfig
from viettts_tpu_torch.ops.mrf import (
    LRELU_SLOPE,
    POST_LRELU_SLOPE,
    conv_transpose_same,
    fused_mrf,
    prepare_mrf_weights,
    storage_dtype,
)


def _same_conv(c_in: int, c_out: int, k: int, dilation: int = 1) -> nn.Conv1d:
    return nn.Conv1d(c_in, c_out, k, dilation=dilation, padding=dilation * (k - 1) // 2)


class ResBlock(nn.Module):
    """ResBlock1 (``convs1``/``convs2``: dilated conv then dilation-1 conv per
    dilation) or ResBlock2 (``convs1`` only: one dilated conv)."""

    def __init__(self, channels: int, k: int, dilations, two_convs: bool):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(_same_conv(channels, channels, k, d) for d in dilations)
        self.convs2 = (
            nn.ModuleList(_same_conv(channels, channels, k) for _ in dilations)
            if two_convs else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs1):
            y = conv(F.leaky_relu(x, LRELU_SLOPE))
            if self.convs2 is not None:
                y = self.convs2[i](F.leaky_relu(y, LRELU_SLOPE))
            x = y + x
        return x


class Generator(nn.Module):
    def __init__(self, cfg: HifiGanConfig):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = _same_conv(cfg.mel_dim, c0, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            # padding is applied by conv_transpose_same (JAX SAME semantics)
            self.ups.append(nn.ConvTranspose1d(2 * ch, ch, k, stride=u))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, rd, cfg.resblock == "1"))
        self.conv_post = _same_conv(c0 // 2 ** len(cfg.upsample_rates), 1, 7)
        self._fused: Dict[Tuple, List] = {}

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """Plain float32 generator: [B, T, n_mels] -> [B, T * 256, 1]."""
        cfg = self.cfg
        n = len(cfg.resblock_kernel_sizes)
        x = self.conv_pre(mel.float().transpose(1, 2))
        for i, (ups, u) in enumerate(zip(self.ups, cfg.upsample_rates)):
            x = conv_transpose_same(F.leaky_relu(x, LRELU_SLOPE), ups.weight, ups.bias, u)
            x = sum(self.resblocks[i * n + j](x) for j in range(n)) / n
        x = self.conv_post(F.leaky_relu(x, POST_LRELU_SLOPE))
        return torch.tanh(x).transpose(1, 2)

    def clear_fused_weights(self) -> None:
        """Drop the cached kernel-layout weights (after loading new ones)."""
        self._fused.clear()

    @torch.no_grad()
    def fused_weights(self, compute_dtype) -> List:
        """Per-stage ``fused_mrf`` arguments in the JAX (W, I, O) layout and
        the storage dtype; built once per (dtype, device) and cached."""
        key = (storage_dtype(compute_dtype), self.conv_pre.weight.device)
        stages = self._fused.get(key)
        if stages is not None:
            return stages

        def wio(conv):  # torch (O, I, W) -> JAX (W, I, O)
            return conv.weight.permute(2, 1, 0)

        cfg = self.cfg
        n = len(cfg.resblock_kernel_sizes)
        stages = []
        for i, (ups, u) in enumerate(zip(self.ups, cfg.upsample_rates)):
            blocks = []
            for rb in self.resblocks[i * n : (i + 1) * n]:
                w1 = torch.stack([wio(c) for c in rb.convs1])
                b1 = torch.stack([c.bias for c in rb.convs1])
                w2 = b2 = None
                if rb.convs2 is not None:
                    w2 = torch.stack([wio(c) for c in rb.convs2])
                    b2 = torch.stack([c.bias for c in rb.convs2])
                blocks.append((w1, b1, w2, b2))
            # invert convt_weight_to_torch: (I, O, W) -> (W, I, O)
            upsample = (ups.weight.permute(2, 0, 1).flip(0), ups.bias, u)
            last = i == len(cfg.upsample_rates) - 1
            post = (wio(self.conv_post), self.conv_post.bias) if last else None
            stages.append(prepare_mrf_weights(blocks, upsample, post, compute_dtype))
        self._fused[key] = stages
        return stages


def generator_apply_fused(
    gen: Generator, mel: torch.Tensor, compute_dtype=torch.float32
) -> torch.Tensor:
    """Serving generator: [B, T, n_mels] -> float32 waveform [B, T * 256, 1].

    ``compute_dtype=torch.bfloat16`` stores the weights and the
    inter-stage activations in bfloat16; arithmetic stays float32.
    conv_pre is a plain torch conv (it is outside the TPU kernel too).
    """
    cfg = gen.cfg
    store = storage_dtype(compute_dtype)
    w_pre = gen.conv_pre.weight.to(store).float()
    x = F.conv1d(mel.to(store).float().transpose(1, 2), w_pre, gen.conv_pre.bias, padding=3)
    x = x.transpose(1, 2).contiguous().to(store)
    for weights, upsample, post in gen.fused_weights(compute_dtype):
        x = fused_mrf(
            x, weights, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
            upsample=upsample, post=post, compute_dtype=compute_dtype,
        )
    return x
