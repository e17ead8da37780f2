"""Plain reference of the three serving models, in PyTorch operations.

Written from the published descriptions, on the seeded numpy trees (the
JAX package's layout: dense kernels [in, out], conv kernels (W, I, O)):

* the token encoder of vietTTS (``nat/model.py``): embedding, 3 x
  [conv k=3 SAME, BatchNorm on its running statistics, relu], a
  bidirectional LSTM whose backward direction restarts at each row's last
  token; haiku's LSTM cell (gates i, g, f, o; +1 on the forget gate);
* the duration model: encoder, dense, gelu (tanh form), dense to 1,
  softplus, in seconds;
* the acoustic model's inference: encoder, Gaussian upsampling
  (``softmax(-(mid - f)^2 / sigma2)`` over the row's tokens), a prenet of
  two bias-free dense + relu layers with dropout masks kept on at inference,
  two LSTM layers fed [context, prenet] and [context, prenet, h1], the
  [h1, h2] projection fed back, then the 5-conv postnet (k=5, BatchNorm and
  tanh on the first 4) added as a residual;
* HiFi-GAN V1's generator (jik876/hifi-gan ``models.py``): conv_pre k=7,
  per stage leaky_relu(0.1), a transposed conv with JAX's SAME padding
  (the input dilated by the stride and correlated with the kernel as given),
  the mean of the ResBlock1 stacks, then leaky_relu(0.01), conv_post, tanh;
  at the precision the configuration states for it (``Reference.wave``).

The reference runs in float32 with TF32 off (``no_tf32``), or, as the
lower-precision control, under bfloat16 autocast.  It imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.nn import functional as F


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


def _lstm_cell(gates, c):
    i, g, f, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm(p, x, reverse=False, reset=None):
    """x [B, L, D] -> [B, L, H]; ``reset`` [B, L] zeroes the state before a step."""
    B, L, _ = x.shape
    H = p["w_h"].shape[0]
    xg = x @ p["w_i"] + p["b"]
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = [None] * L
    for t in (reversed(range(L)) if reverse else range(L)):
        if reset is not None:
            keep = (~reset[:, t]).to(x.dtype)[:, None]
            h, c = h * keep, c * keep
        h, c = _lstm_cell(xg[:, t] + h @ p["w_h"], c)
        out[t] = h
    return torch.stack(out, 1)


def _conv(x, p, dilation=1):
    """SAME conv of x [B, C, L] with a (W, I, O) kernel."""
    w = p["kernel"]
    pad = dilation * (w.shape[0] - 1) // 2
    return F.conv1d(x, w.permute(2, 1, 0), p["bias"], padding=pad, dilation=dilation)


def _batch_norm(x, p, s, eps=1e-5):
    return (x - s["mean"][:, None]) * torch.rsqrt(s["var"][:, None] + eps) * p["scale"][:, None] + p["bias"][:, None]


def encoder(params, stats, tokens, lengths):
    """tokens [B, T] long, lengths [B] -> [B, T, 2C]."""
    x = params["embed"]["embedding"][tokens].transpose(1, 2)
    for i in range(3):
        x = torch.relu(_batch_norm(_conv(x, params[f"conv_{i}"]), params[f"bn_{i}"], stats[f"bn_{i}"]))
    x = x.transpose(1, 2)
    T = tokens.shape[1]
    reset = torch.arange(T, device=tokens.device)[None, :] >= (lengths[:, None] - 1)
    return torch.cat([_lstm(params["lstm_fwd"], x), _lstm(params["lstm_bwd"], x, True, reset)], -1)


def conv_transpose_same(x, p, stride):
    """JAX's ``conv_transpose(..., padding='SAME')`` of x [B, C_in, L] with a
    (W, I, O) kernel: the input dilated by ``stride``, padded by
    ``k + s - 2`` split as JAX splits it, correlated with the kernel."""
    w = p["kernel"]
    k = w.shape[0]
    B, C, L = x.shape
    xd = x.new_zeros(B, C, (L - 1) * stride + 1)
    xd[..., ::stride] = x
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    xd = F.pad(xd, (pad_a, pad_len - pad_a))
    return F.conv1d(xd, w.permute(2, 1, 0), p["bias"])


class Reference:
    """The three models of one seeded configuration on ``device``."""

    def __init__(self, trees: dict, sizes: Dict[str, object], device: torch.device):
        self.sizes = sizes
        self.device = device
        self.dur = _tensors(trees["duration"], device)
        self.ac = _tensors(trees["acoustic"], device)
        self.gen = _tensors(trees["hifigan"]["params"], device)
        self.fps = sizes["dsp.sample_rate"] / sizes["dsp.hop_length"]

    @torch.no_grad()
    def durations(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Seconds [B, T], word ends and padding zeroed (no silence clamp)."""
        p, s = self.dur["params"], self.dur["batch_stats"]
        x = encoder(p["encoder"], s["encoder"], tokens, lengths)
        x = F.gelu(x @ p["proj_0"]["kernel"] + p["proj_0"]["bias"], approximate="tanh")
        d = F.softplus((x @ p["proj_1"]["kernel"] + p["proj_1"]["bias"])[..., 0]).float()
        mask = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
        return torch.where((tokens == 3) | ~mask, 0.0, d)

    @torch.no_grad()
    def mel(self, tokens, lengths, frames, n_frames: int, keep1, keep2, keep_prob: float) -> torch.Tensor:
        """Log-mel [B, n_frames, D] after the postnet.  ``frames`` [B, T] are
        the durations in frames; ``keep1``/``keep2`` [n_frames, B, P] the
        prenet's keep masks."""
        p, s = self.ac["params"], self.ac["batch_stats"]
        enc = encoder(p["encoder"], s["encoder"], tokens, lengths)
        T = tokens.shape[1]
        end = torch.cumsum(frames, 1)
        mid = end - frames / 2.0
        f = torch.arange(n_frames, device=tokens.device, dtype=torch.float32)
        logits = -torch.square(mid[:, None, :] - f[None, :, None]) / self.sizes["acoustic.upsample_sigma2"]
        token_mask = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
        logits = logits.masked_fill(~token_mask[:, None, :], float("-inf"))
        cond = torch.softmax(logits, -1) @ enc  # [B, L, C]
        C, P = cond.shape[-1], p["prenet_fc2"]["kernel"].shape[0]
        l1, l2 = p["decoder_lstm1"], p["decoder_lstm2"]
        g1c = cond @ l1["w_i"][:C] + l1["b"]
        g2c = cond @ l2["w_i"][:C] + l2["b"]
        w1p, w2p, w2h1 = l1["w_i"][C:], l2["w_i"][C:C + P], l2["w_i"][C + P:]
        B, H = tokens.shape[0], l1["w_h"].shape[0]
        h1, c1, h2, c2 = (cond.new_zeros(B, H) for _ in range(4))
        mel = cond.new_zeros(B, p["projection"]["kernel"].shape[1])
        scale = 1.0 / keep_prob
        out = []
        for t in range(n_frames):
            q = torch.relu(mel @ p["prenet_fc1"]["kernel"]) * keep1[t] * scale
            q = torch.relu(q @ p["prenet_fc2"]["kernel"]) * keep2[t] * scale
            h1, c1 = _lstm_cell(g1c[:, t] + q @ w1p + h1 @ l1["w_h"], c1)
            h2, c2 = _lstm_cell(g2c[:, t] + q @ w2p + h1 @ w2h1 + h2 @ l2["w_h"], c2)
            mel = torch.cat([h1, h2], -1) @ p["projection"]["kernel"] + p["projection"]["bias"]
            out.append(mel)
        mel = torch.stack(out, 1).float()
        x = mel.transpose(1, 2)
        for i in range(5):
            x = _conv(x, p[f"postnet_conv_{i}"])
            if i < 4:
                x = torch.tanh(_batch_norm(x, p[f"postnet_bn_{i}"], s[f"postnet_bn_{i}"]))
        return mel + x.float().transpose(1, 2)

    @torch.no_grad()
    def wave(self, mel: torch.Tensor, dtype: Optional[str] = None) -> torch.Tensor:
        """Waveform [B, n_frames * 256] of a log-mel [B, n_frames, D], at the
        vocoder precision the configuration states
        (``hifigan.inference_dtype``): ``float32``, or ``bfloat16``: every
        product's operands in bfloat16 (the weights; the mel; each conv's
        input after its leaky_relu; conv_pre's output and bias and each
        stage's output, which are stored) and every sum in float32
        (conv_post's input stays float32).  ``dtype`` overrides the stated
        one."""
        g, sz = self.gen, self.sizes
        dtype = dtype or sz["hifigan.inference_dtype"]

        def r(t):
            if dtype == "bfloat16":
                return t.to(torch.bfloat16).float()
            if dtype == "float8":  # e4m3 with a per-tensor scale to its largest value, the control's step below
                scale = t.abs().amax().clamp_min(1e-30) / 448.0
                return (t / scale).to(torch.float8_e4m3fn).float() * scale
            return t

        def w(p, bias=False):
            return {"kernel": r(p["kernel"]), "bias": r(p["bias"]) if bias else p["bias"]}

        rks, rds = sz["hifigan.resblock_kernel_sizes"], sz["hifigan.resblock_dilation_sizes"]
        pre = w(g["conv_pre"], bias=True)
        x = _conv(r(mel).transpose(1, 2), {"kernel": pre["kernel"], "bias": torch.zeros_like(pre["bias"])})
        x = r(r(x) + pre["bias"][:, None])
        rates = sz["hifigan.upsample_rates"]
        for i, u in enumerate(rates):
            x = conv_transpose_same(r(F.leaky_relu(x, 0.1)), w(g[f"ups_{i}"]), u)
            acc = None
            for j, dils in enumerate(rds):
                blk = g[f"resblock_{i * len(rks) + j}"]
                h = x
                for m, d in enumerate(dils):
                    y = _conv(r(F.leaky_relu(h, 0.1)), w(blk[f"convs1_{m}"]), d)
                    h = _conv(r(F.leaky_relu(y, 0.1)), w(blk[f"convs2_{m}"]), 1) + h
                acc = h if acc is None else acc + h
            x = acc / len(rks)
            if i < len(rates) - 1:
                x = r(x)
        x = _conv(F.leaky_relu(x, 0.01), w(g["conv_post"]))
        return torch.tanh(x.float())[:, 0]


def keep_masks(seed: int, n_frames: int, rows: int, prenet_dim: int, keep_prob: float, device) -> List[torch.Tensor]:
    """The prenet's keep masks of one dispatch, drawn as the serving path
    draws them: a generator on the device seeded with the prenet seed, two
    uniform draws of [n_frames, rows, prenet_dim], kept below ``keep_prob``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shape = (n_frames, rows, prenet_dim)
    return [torch.rand(shape, generator=gen, device=device) < keep_prob
            for _ in range(2)]
