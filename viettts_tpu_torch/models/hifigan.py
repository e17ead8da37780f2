"""HiFi-GAN generator (counterpart of the ``Generator`` and the fused
serving path in ``viettts_tpu/models/hifigan.py``).

Mel [B, T, n_mels] -> conv_pre -> 4 stages of [leaky_relu ->
ConvTranspose(stride u, SAME) -> mean of the multi-receptive-field
resblocks] -> leaky_relu(0.01) -> conv_post -> tanh: [B, T * 256, 1].

``Generator.forward`` is the plain formulation with torch convs.  With
``use_wn=True`` every conv is weight-normalized (``WNConv``: ``{v, g,
bias}``, folded in the parameters' dtype), as the GAN trainer trains it;
``dtype`` is the compute dtype (bfloat16 under mixed precision: convs,
bias adds and activations in it, ``tanh`` in float32).
``generator_apply_fused`` is the serving path: every stage, ConvTranspose
prologue included and the tail fused into the last one, goes through
``fused_mrf`` (kernel K2 on CUDA), with float32 or bfloat16 storage, and
on the int8 route with its MRF convs in kernel K3, but for the stages
whose tile geometry the TPU kernel refuses, which take JAX's fallbacks
(``int8_rungs``; ``xla_stage``: JAX's XLA stage in plain torch).
``generator_calibrate_int8`` and ``generator_int8_clip_stats`` walk the
plain float32 generator for the int8 route's static activation scales and
its clip-rate probe.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.config import HifiGanConfig
from viettts_tpu_torch.ops.mrf import (
    LRELU_SLOPE,
    POST_LRELU_SLOPE,
    _dense,
    conv_transpose_same,
    convt_weight_to_torch,
    fused_mrf,
    jax_tile_geometry,
    mrf_walk,
    prepare_mrf_weights,
    storage_dtype,
)


def weight_norm(v: torch.Tensor, g: torch.Tensor, out_axis: int = 0) -> torch.Tensor:
    """``g * v / max(||v||, 1e-12)``, the norm over every axis of ``v`` but
    ``out_axis`` (the output channels), in ``v``'s dtype."""
    dims = [d for d in range(v.dim()) if d != out_axis]
    norm = torch.linalg.vector_norm(v, dim=dims, keepdim=True)
    shape = [1] * v.dim()
    shape[out_axis] = -1
    return v * (g.view(shape) / norm.clamp_min(1e-12))


class WNConv(nn.Module):
    """A weight-normalized conv: parameters ``v`` (torch's layout: (O, I/g,
    k...) for Conv1d/Conv2d, ``out_axis=1`` for ConvTranspose1d's (I, O,
    k)), ``g`` and ``bias`` [O], and the hyper-parameters as ``nn.ConvNd``
    names them.  ``weight`` is the folded kernel (``weight_norm``);
    ``forward`` runs a Conv1d or Conv2d in the input's dtype."""

    def __init__(self, shape, out_axis: int = 0, stride=1, padding=0, dilation=1, groups: int = 1):
        super().__init__()
        self.v = nn.Parameter(torch.zeros(shape))
        self.g = nn.Parameter(torch.ones(shape[out_axis]))
        self.bias = nn.Parameter(torch.zeros(shape[out_axis]))
        self.out_axis = out_axis
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups

    @property
    def weight(self) -> torch.Tensor:
        return weight_norm(self.v, self.g, self.out_axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(self, x)


def conv(module, x: torch.Tensor) -> torch.Tensor:
    """``module``'s Conv1d or Conv2d (an ``nn.ConvNd`` or a ``WNConv``) in
    ``x``'s dtype: the conv, then the bias added in that dtype, as the JAX
    package's convs do (``preferred_element_type`` = the compute dtype)."""
    w = module.weight.to(x.dtype)
    fn = F.conv1d if w.dim() == 3 else F.conv2d
    y = fn(x, w, None, module.stride, module.padding, module.dilation, module.groups)
    return y + module.bias.to(x.dtype).view(-1, *([1] * (w.dim() - 2)))


def _same_conv(c_in: int, c_out: int, k: int, dilation: int = 1, use_wn: bool = False) -> nn.Module:
    pad = dilation * (k - 1) // 2
    if use_wn:
        return WNConv((c_out, c_in, k), padding=pad, dilation=dilation)
    return nn.Conv1d(c_in, c_out, k, dilation=dilation, padding=pad)


class ResBlock(nn.Module):
    """ResBlock1 (``convs1``/``convs2``: dilated conv then dilation-1 conv per
    dilation) or ResBlock2 (``convs1`` only: one dilated conv)."""

    def __init__(self, channels: int, k: int, dilations, two_convs: bool, use_wn: bool = False):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(_same_conv(channels, channels, k, d, use_wn) for d in dilations)
        self.convs2 = (
            nn.ModuleList(_same_conv(channels, channels, k, 1, use_wn) for _ in dilations)
            if two_convs else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, c in enumerate(self.convs1):
            y = conv(c, F.leaky_relu(x, LRELU_SLOPE))
            if self.convs2 is not None:
                y = conv(self.convs2[i], F.leaky_relu(y, LRELU_SLOPE))
            x = y + x
        return x


class Generator(nn.Module):
    def __init__(self, cfg: HifiGanConfig, use_wn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.use_wn = use_wn
        self.dtype = dtype
        c0 = cfg.upsample_initial_channel
        self.conv_pre = _same_conv(cfg.mel_dim, c0, 7, 1, use_wn)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            # padding is applied by conv_transpose_same (JAX SAME semantics)
            self.ups.append(
                WNConv((2 * ch, ch, k), out_axis=1, stride=u) if use_wn
                else nn.ConvTranspose1d(2 * ch, ch, k, stride=u)
            )
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, rd, cfg.resblock == "1", use_wn))
        self.conv_post = _same_conv(c0 // 2 ** len(cfg.upsample_rates), 1, 7, 1, use_wn)
        self._fused: Dict[Tuple, List] = {}

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """Plain generator in ``self.dtype``: [B, T, n_mels] -> float32
        [B, T * 256, 1]."""
        cfg = self.cfg
        dt = self.dtype
        n = len(cfg.resblock_kernel_sizes)
        x = conv(self.conv_pre, mel.to(dt).transpose(1, 2))
        for i, (ups, u) in enumerate(zip(self.ups, cfg.upsample_rates)):
            x = conv_transpose_same(F.leaky_relu(x, LRELU_SLOPE), ups.weight.to(dt), ups.bias.to(dt), u)
            x = sum(self.resblocks[i * n + j](x) for j in range(n)) / n
        x = conv(self.conv_post, F.leaky_relu(x, POST_LRELU_SLOPE))
        return torch.tanh(x.float()).transpose(1, 2)

    def clear_fused_weights(self) -> None:
        """Drop the cached kernel-layout weights (after loading new ones)."""
        self._fused.clear()

    @torch.no_grad()
    def fused_weights(self, compute_dtype, quantize_int8: bool = False) -> List:
        """Per-stage ``fused_mrf`` arguments in the JAX (W, I, O) layout and
        the storage dtype (MRF convs as int8 codes with ``quantize_int8``,
        quantized from the float32 weights); built once per (dtype, int8,
        device) and cached."""
        key = (storage_dtype(compute_dtype), quantize_int8, self.conv_pre.weight.device)
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
            stages.append(prepare_mrf_weights(blocks, upsample, post, compute_dtype, quantize_int8))
        self._fused[key] = stages
        return stages


# The rungs of JAX's ladder on the int8 route, a stage each
# (viettts_tpu/models/hifigan.py:733-818), from the TPU kernel's refusals:
# FUSED, its fused call with the ConvTranspose prologue (:735-758);
# XLA_PROLOGUE, the prologue as an XLA ConvTranspose (:769-778), then the
# fused call without it (:779-804); XLA_STAGE, where that call refuses too,
# the whole stage on XLA in the compute dtype, unquantized (``xla_mrf``,
# :671-694, called at :816; on the last stage the tail, :819-823).
FUSED, XLA_PROLOGUE, XLA_STAGE = "fused", "xla_prologue", "xla_stage"


def int8_rungs(stages, frames: int, store, kernel_sizes, dilations) -> List[str]:
    """JAX's rung of each stage (``fused_weights``' stages) on the int8 route
    for mels of ``frames`` frames in storage ``store``, from the TPU
    kernel's refusals (``ops.mrf.jax_tile_geometry``): ``FUSED`` runs the
    stage through ``fused_mrf`` with its prologue (K3 on the card),
    ``XLA_PROLOGUE`` runs ``_xla_upsample`` and then ``fused_mrf`` without
    the prologue (K3), ``XLA_STAGE`` runs ``xla_stage`` (plain torch, no
    kernel)."""
    rungs, L_in = [], frames
    for weights, upsample, post in stages:
        k_u, C_in, C = _dense(upsample[0]).shape
        u = upsample[2]
        args = (kernel_sizes, dilations, weights[0][2] is None)
        kw = dict(post_k=None if post is None else post[0].shape[0], store=store, quantize_int8=True)
        if jax_tile_geometry(L_in, C_in, C, *args, upsample=(k_u, u), **kw).error is None:
            rungs.append(FUSED)
        elif jax_tile_geometry(L_in * u, C, C, *args, **kw).error is None:
            rungs.append(XLA_PROLOGUE)
        else:
            rungs.append(XLA_STAGE)
        L_in *= u
    return rungs


def _lrelu_in(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu`` in ``x``'s dtype: the slope rounded to that
    dtype, as a weakly typed scalar is, and the product rounded to it (one
    rounding of an exact float32 product)."""
    return F.leaky_relu(x, torch.tensor(slope, dtype=x.dtype).item())


def _xla_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int, store) -> torch.Tensor:
    """The ``conv`` of JAX's XLA fallback (viettts_tpu/models/hifigan.py:657-668)
    on x [B, C_in, L] in ``store``, a JAX-layout weight (W, I, O): the SAME
    conv of the weight rounded to ``store``, its sums rounded to ``store``,
    then the bias added in ``store``.  The sums run in float64 and round
    once to float32, as ``conv_pre`` and ``_xla_upsample`` do: exact
    products, so every device rounds them to the same ``store`` values.
    The conv is one float64 matrix product over the taps' shifted copies
    of x (cuDNN's float64 convs took twice as long on the H100)."""
    k, c_in, c_out = w.shape
    p, L = d * (k - 1) // 2, x.shape[-1]
    xp = F.pad(x, (p, p)).double()
    cols = torch.cat([xp[:, :, t * d:t * d + L] for t in range(k)], dim=1)  # [B, k * C_in, L], tap-major
    y = torch.matmul(w.to(store).double().reshape(k * c_in, c_out).t(), cols).float().to(store)
    return y + b.to(store)[None, :, None]


def xla_stage(x: torch.Tensor, weights, upsample, post, kernel_sizes, dilations, store) -> torch.Tensor:
    """JAX's XLA fallback for a stage the TPU kernel refuses (the
    ``XLA_STAGE`` rung), plain torch on ``x``'s device: ``_xla_upsample``,
    then ``xla_mrf`` (viettts_tpu/models/hifigan.py:671-694) with every
    leaky_relu, conv, bias, residual add, the resblocks' sum and its
    division rounded to ``store``, and on the last stage the tail
    (:819-823): leaky_relu 0.01 and conv_post in ``store``, tanh in
    float32.  ``x`` [B, L_in, C_in] in ``store`` and a stage of the
    unquantized ``fused_weights`` -> [B, L, C] in ``store``, or the
    float32 waveform [B, L, 1]."""
    h = _xla_upsample(x, upsample, store).transpose(1, 2)  # [B, C, L]
    acc = None
    for (w1, b1, w2, b2), dils in zip(weights, dilations):
        r = h
        for j, d in enumerate(dils):
            y = _xla_conv(_lrelu_in(r, LRELU_SLOPE), _dense(w1)[j], b1[j], d, store)
            if w2 is not None:
                y = _xla_conv(_lrelu_in(y, LRELU_SLOPE), _dense(w2)[j], b2[j], 1, store)
            r = y + r
        acc = r if acc is None else acc + r
    h = acc / len(kernel_sizes)  # exact or never near a tie, however the device divides
    if post is None:
        return h.transpose(1, 2).contiguous()
    w_p, b_p = post
    y = _xla_conv(_lrelu_in(h, POST_LRELU_SLOPE), w_p, b_p, 1, store)
    return torch.tanh(y.float()).transpose(1, 2).contiguous()


def _xla_upsample(x: torch.Tensor, upsample, store) -> torch.Tensor:
    """JAX's XLA prologue of the ``XLA_PROLOGUE`` and ``XLA_STAGE`` rungs
    (viettts_tpu/models/hifigan.py:767-778): leaky_relu in the storage
    dtype, the ConvTranspose rounded to it, then the bias added in it;
    [B, L_in, C_in] -> [B, L_in * u, C] in ``store``.  The sums run in
    float64 and round once to float32, as the int8 route's conv_pre does."""
    w_t, b_t, u = upsample
    a = _lrelu_in(x, LRELU_SLOPE)
    zero = torch.zeros(b_t.shape[0], dtype=torch.float64, device=x.device)
    h = conv_transpose_same(a.transpose(1, 2).double(), convt_weight_to_torch(_dense(w_t).double()), zero, u)
    h = h.float().to(store).float() + b_t.to(store).float()[None, :, None]
    return h.transpose(1, 2).contiguous().to(store)


def generator_apply_fused(
    gen: Generator,
    mel: torch.Tensor,
    compute_dtype=torch.float32,
    quantize_int8: bool = False,
    act_scales: Optional[Dict[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Serving generator: [B, T, n_mels] -> float32 waveform [B, T * 256, 1].

    ``compute_dtype=torch.bfloat16`` stores the weights and the
    inter-stage activations in bfloat16; arithmetic stays float32.
    conv_pre is a plain torch conv (it is outside the TPU kernel too).
    ``quantize_int8`` runs the stages' MRF convs in int8 (K3) wherever the
    JAX int8 route quantizes them.  A stage whose tile geometry the TPU
    kernel refuses takes JAX's fallback (``int8_rungs``): the
    ConvTranspose prologue on XLA (``_xla_upsample``) before the quantized
    MRF, or, where the MRF call refuses too, JAX's XLA stage in the
    storage dtype (``xla_stage``, no kernel).  ``act_scales`` ``{stage:
    [n_convs]}`` (``generator_calibrate_int8``) selects static activation
    scales, else they are dynamic (one a tile window).
    """
    cfg = gen.cfg
    store = storage_dtype(compute_dtype)
    stages = gen.fused_weights(compute_dtype, quantize_int8)
    rungs = [FUSED] * len(stages)
    if quantize_int8:
        rungs = int8_rungs(stages, mel.shape[1], store, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
    # as JAX's conv_pre: the conv rounds to the storage dtype, then the
    # bias is added in it (one bf16 rounding less moves the int8 route's
    # codes, and its waveform by ~1% rel-RMS).  On the int8 route the sums
    # are float64 (exact products, one rounding), as in the prologue, so
    # that every device rounds them to the same bf16 values, which the
    # int8 codes would otherwise amplify.
    acc = torch.float64 if quantize_int8 else torch.float32
    w_pre = gen.conv_pre.weight.to(store).to(acc)
    x = F.conv1d(mel.to(store).to(acc).transpose(1, 2), w_pre, padding=3).float()
    x = x.to(store).float() + gen.conv_pre.bias.to(store).float()[None, :, None]
    x = x.transpose(1, 2).contiguous().to(store)
    for i, (weights, upsample, post) in enumerate(stages):
        if rungs[i] == XLA_STAGE:  # the float weights of the storage dtype's route
            x = xla_stage(x, *gen.fused_weights(compute_dtype)[i], cfg.resblock_kernel_sizes,
                          cfg.resblock_dilation_sizes, store)
            continue
        if rungs[i] == XLA_PROLOGUE:
            x, upsample = _xla_upsample(x, upsample, store), None
        x = fused_mrf(
            x, weights, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
            upsample=upsample, post=post, compute_dtype=compute_dtype,
            quantize_int8=quantize_int8, act_scales=(act_scales or {}).get(i) if quantize_int8 else None,
        )
    return x


@torch.no_grad()
def _mrf_activation_walk(
    gen: Generator, mel: torch.Tensor, metric: Callable[[int, int, torch.Tensor], torch.Tensor]
) -> Dict[int, torch.Tensor]:
    """Run the plain float32 generator on ``mel`` and reduce every MRF conv
    input with ``metric(stage, conv_index, activation)``, in the flat conv
    order ``fused_mrf`` quantizes in.  Returns ``{stage: [n_convs] f32}``."""
    cfg = gen.cfg
    x = gen.conv_pre(mel.float().transpose(1, 2))
    out = {}
    for i, (weights, upsample, _) in enumerate(gen.fused_weights(torch.float32)):
        x, vals = mrf_walk(
            x, weights, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
            lambda j, y: metric(i, j, y), upsample=upsample,
        )
        out[i] = torch.stack(vals)
    return out


def generator_calibrate_int8(gen: Generator, mel: torch.Tensor, margin: float = 1.0):
    """Per-conv activation amaxes for static int8 MRF quantization:
    ``max|leaky_relu(conv input)| * margin`` for every MRF conv of every
    stage, ``{stage: [n_convs] f32}``; pass it to
    ``generator_apply_fused(act_scales=...)``.  Inputs beyond the
    calibrated range are clipped by the kernel, so calibrate on diverse
    utterances (``Synthesizer.calibrate_int8`` maxes over several) and keep
    a margin; ``generator_int8_clip_stats`` shows what clips."""
    return _mrf_activation_walk(gen, mel, lambda i, j, y: y.abs().amax() * margin)


def generator_int8_clip_stats(gen: Generator, mel: torch.Tensor, act_scales: Dict[int, torch.Tensor]):
    """Fraction of each MRF conv input's elements whose magnitude exceeds
    its calibrated amax (what the static int8 route clips), ``{stage:
    [n_convs] f32}``.  Costs one float32 generator forward: a sampled
    serving probe, not a per-request one."""
    return _mrf_activation_walk(
        gen, mel, lambda i, j, y: (y.abs() > act_scales[i][j]).float().mean()
    )
