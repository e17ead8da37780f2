"""One HiFi-GAN generator stage: CUDA kernel K2 and its plain twin.

Counterpart of ``viettts_tpu/ops/mrf.py::fused_mrf``.  A stage is

* an optional prologue: leaky_relu(0.1), then ConvTranspose1d (stride u,
  JAX "SAME" padding);
* the multi-receptive-field (MRF) stack: for each resblock and dilation d,
  ``x += conv_k,1(lrelu(conv_k,d(lrelu(x))))`` (ResBlock1) or
  ``x += conv_k,d(lrelu(x))`` (ResBlock2), the resblock outputs averaged;
* an optional epilogue: leaky_relu(0.01), conv_post, tanh.

Every conv zero-pads at the true sequence edges ("SAME").  Weights keep the
JAX (W, I, O) layout: ``weights[blk] = (W1 [D,k,C,C], B1 [D,C], W2, B2)``
with ``W2 = B2 = None`` for ResBlock2, ``upsample = (w [k,C_in,C], b [C],
u)`` and ``post = (w [kp,C,C_post], b [C_post])``.  ``compute_dtype``
selects the storage dtype of the weights and of the stage input and output
(float32 or bfloat16); biases are float32 and all arithmetic is float32,
as in the TPU kernel.  ``prepare_mrf_weights`` casts a float32 weight set
to that layout once.

``fused_mrf`` runs ``csrc/mrf.cu`` on CUDA tensors and ``fused_mrf_plain``
on CPU tensors; any other device raises.  ``fused_mrf.launches`` counts
stages run on the kernels and ``fused_mrf.plain_calls`` counts calls of
the twin.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from viettts_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
POST_LRELU_SLOPE = 0.01  # torch's default slope, as upstream HiFi-GAN uses
MAX_POST_CHANNELS = 4  # the epilogue kernel keeps one accumulator per channel


def storage_dtype(compute_dtype) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32


def convt_lead_pad(k: int, u: int) -> int:
    """Leading pad of JAX's SAME ``conv_transpose`` (lax._conv_transpose_padding):
    input row i reaches output n = i*u + pad_a - t through tap t."""
    return k - 1 if u > k - 1 else -(-(k + u - 2) // 2)


def conv_transpose_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, u: int
) -> torch.Tensor:
    """JAX-SAME ConvTranspose1d on [B, C_in, L] with a torch-layout weight
    [C_in, C_out, k] -> [B, C_out, L*u]."""
    k = w.shape[-1]
    n = x.shape[-1] * u
    y = F.conv_transpose1d(x, w, stride=u)  # full output, length (L-1)*u + k
    start = k - 1 - convt_lead_pad(k, u)
    y = F.pad(y, (0, max(0, start + n - y.shape[-1])))[..., start : start + n]
    return y + b[None, :, None]


def convt_weight_to_torch(w: torch.Tensor) -> torch.Tensor:
    """JAX ConvTranspose kernel (W, I, O) -> torch (I, O, W): torch applies
    the taps mirrored relative to ``lax.conv_transpose``."""
    return w.flip(0).permute(1, 2, 0)


def _conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """SAME conv on [B, C, L] with a JAX-layout weight (W, I, O)."""
    k = w.shape[0]
    return F.conv1d(
        x, w.float().permute(2, 1, 0), b.float(),
        padding=d * (k - 1) // 2, dilation=d,
    )


def fused_mrf_plain(
    x: torch.Tensor,
    weights: Sequence[Tuple],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    *,
    upsample: Optional[Tuple] = None,
    post: Optional[Tuple] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch twin of the stage kernels: float32 arithmetic, rounding
    to the storage dtype only where the kernel stores."""
    fused_mrf.plain_calls += 1
    h = x.float().transpose(1, 2)  # [B, C, L]
    if upsample is not None:
        w_t, b_t, u = upsample
        h = conv_transpose_same(
            F.leaky_relu(h, LRELU_SLOPE),
            convt_weight_to_torch(w_t.float()), b_t.float(), u,
        )
    acc = None
    for blk in range(len(kernel_sizes)):
        w1, b1, w2, b2 = weights[blk]
        r = h
        for j, d in enumerate(dilations[blk]):
            y = _conv_same(F.leaky_relu(r, LRELU_SLOPE), w1[j], b1[j], d)
            if w2 is not None:
                y = _conv_same(F.leaky_relu(y, LRELU_SLOPE), w2[j], b2[j], 1)
            r = y + r
        acc = r if acc is None else acc + r
    acc = acc / len(kernel_sizes)
    if post is not None:
        w_p, b_p = post
        z = _conv_same(F.leaky_relu(acc, POST_LRELU_SLOPE), w_p, b_p, 1)
        return torch.tanh(z).transpose(1, 2).contiguous()
    return acc.transpose(1, 2).contiguous().to(storage_dtype(compute_dtype))


def prepare_mrf_weights(weights, upsample=None, post=None, compute_dtype=torch.float32):
    """Cast a float32 weight set to what ``fused_mrf`` takes: weights in the
    storage dtype, biases in float32, all contiguous."""
    store = storage_dtype(compute_dtype)

    def w(t):
        return None if t is None else t.to(store).contiguous()

    def b(t):
        return None if t is None else t.float().contiguous()

    weights = [(w(w1), b(b1), w(w2), b(b2)) for w1, b1, w2, b2 in weights]
    if upsample is not None:
        upsample = (w(upsample[0]), b(upsample[1]), int(upsample[2]))
    if post is not None:
        post = (w(post[0]), b(post[1]))
    return weights, upsample, post


def _check(x, weights, kernel_sizes, dilations, upsample, post, store):
    """Validate shapes, dtypes, devices and contiguity; returns (L, C)."""
    if x.dim() != 3 or x.dtype != store:
        raise ValueError(f"fused_mrf: x must be [B, L, C] {store}, got {tuple(x.shape)} {x.dtype}")
    if len(weights) != len(kernel_sizes) or len(dilations) != len(kernel_sizes):
        raise ValueError("fused_mrf: weights, kernel_sizes and dilations differ in length")
    tensors = [("x", x, store)]
    if upsample is not None:
        w_t, b_t, u = upsample
        k_u, c_in, C = w_t.shape
        if c_in != x.shape[2] or tuple(b_t.shape) != (C,):
            raise ValueError(f"fused_mrf: upsample weight {tuple(w_t.shape)} does not fit x {tuple(x.shape)}")
        L = x.shape[1] * u
        tensors += [("upsample w", w_t, store), ("upsample b", b_t, torch.float32)]
    else:
        L, C = x.shape[1], x.shape[2]
    for blk, k in enumerate(kernel_sizes):
        w1, b1, w2, b2 = weights[blk]
        n = len(dilations[blk])
        if k % 2 != 1:
            raise ValueError(f"fused_mrf: resblock kernel size {k} must be odd")
        for name, w, b in (("W1", w1, b1), ("W2", w2, b2)):
            if w is None and name == "W2":
                if b is not None:
                    raise ValueError("fused_mrf: W2 is None but B2 is not")
                continue
            if tuple(w.shape) != (n, k, C, C) or tuple(b.shape) != (n, C):
                raise ValueError(
                    f"fused_mrf: block {blk} {name} {tuple(w.shape)} / bias {tuple(b.shape)}, "
                    f"want {(n, k, C, C)} / {(n, C)}"
                )
            tensors += [(f"{name}[{blk}]", w, store), (f"B{name[1]}[{blk}]", b, torch.float32)]
    if post is not None:
        w_p, b_p = post
        kp, c, cp = w_p.shape
        if c != C or tuple(b_p.shape) != (cp,) or kp % 2 != 1:
            raise ValueError(f"fused_mrf: post weight {tuple(w_p.shape)} does not fit C={C}")
        tensors += [("post w", w_p, store), ("post b", b_p, torch.float32)]
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise ValueError(f"fused_mrf: {name} is {t.dtype}, want {dtype}")
        if t.device != x.device:
            raise ValueError(f"fused_mrf: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_mrf: {name} is not contiguous")
    return L, C


def fused_mrf(
    x: torch.Tensor,
    weights: Sequence[Tuple],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    *,
    upsample: Optional[Tuple] = None,
    post: Optional[Tuple] = None,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Apply one (ConvTranspose +) MRF (+ conv_post) stage.

    Without ``upsample`` x is [B, L, C]; with it x is [B, L/u, C_in].
    Returns [B, L, C] in the storage dtype, or the float32 [B, L, C_post]
    waveform when ``post`` is given.
    """
    store = storage_dtype(compute_dtype)
    L, C = _check(x, weights, kernel_sizes, dilations, upsample, post, store)
    kwargs = dict(upsample=upsample, post=post, compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        return fused_mrf_plain(x, weights, kernel_sizes, dilations, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mrf: no kernel for device {x.device}")
    if post is not None and post[0].shape[2] > MAX_POST_CHANNELS:
        raise ValueError(f"fused_mrf kernel takes at most {MAX_POST_CHANNELS} post channels")
    return _fused_mrf_cuda(x, weights, kernel_sizes, dilations, upsample, post, store, L, C)


def _fused_mrf_cuda(x, weights, kernel_sizes, dilations, upsample, post, store, L, C):
    lib = _build.load_library()
    stream = _build.stream_ptr(x.device)
    bf = int(store == torch.bfloat16)
    B = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    fused_mrf.launches += 1

    if upsample is not None:
        w_t, b_t, u = upsample
        k_u, c_in, _ = w_t.shape
        h = torch.empty(B, L, C, **f32)
        _build.check(
            lib.viettts_mrf_convt(
                bf, x.data_ptr(), w_t.data_ptr(), b_t.data_ptr(), h.data_ptr(),
                B, x.shape[1], c_in, C, k_u, u, convt_lead_pad(k_u, u), stream,
            ),
            "fused_mrf prologue",
        )
    elif store == torch.float32:
        h = x  # read only: the MRF never writes its trunk
    else:
        h = torch.empty(B, L, C, **f32)
        _build.check(
            lib.viettts_mrf_to_f32(x.data_ptr(), h.data_ptr(), x.numel(), stream),
            "fused_mrf input cast",
        )

    n_blocks = len(kernel_sizes)
    bufs = (torch.empty(B, L, C, **f32), torch.empty(B, L, C, **f32))
    acc = torch.empty(B, L, C, **f32) if n_blocks > 1 else None
    out_dtype = torch.float32 if post is not None else store
    out = torch.empty(B, L, C, dtype=out_dtype, device=x.device)
    out_bf = int(out_dtype == torch.bfloat16)

    def other(t):
        return bufs[1] if t is bufs[0] else bufs[0]

    def conv(inp, w, b, k, d, res, y, mode=0, out_ptr=None):
        # mode 0: y = v; 1: y += v; 2: out = ((y or 0) + v) / n_blocks,
        # where v = conv_k,d(lrelu(inp)) + b (+ res)
        _build.check(
            lib.viettts_mrf_conv(
                bf, out_bf, inp.data_ptr(), w.data_ptr(), b.data_ptr(),
                None if res is None else res.data_ptr(),
                None if y is None else y.data_ptr(), out_ptr,
                B, L, C, C, k, d, mode, float(n_blocks), stream,
            ),
            "fused_mrf conv",
        )

    for blk, k in enumerate(kernel_sizes):
        w1, b1, w2, b2 = weights[blk]
        cur = h
        dils = dilations[blk]
        for j, d in enumerate(dils):
            if w2 is not None:  # ResBlock1: dilated conv, then a dilation-1 conv
                t = other(cur)
                conv(cur, w1[j], b1[j], k, d, None, t)
                src, w, b, dil = t, w2[j], b2[j], 1
            else:  # ResBlock2: one dilated conv
                src, w, b, dil = cur, w1[j], b1[j], d
            if j < len(dils) - 1:
                # never the conv's own input (other blocks read its halo);
                # writing over the residual is safe: each element is read
                # and written by the same thread
                dst = other(src)
                conv(src, w, b, k, dil, cur, dst)
                cur = dst
            elif blk < n_blocks - 1:
                conv(src, w, b, k, dil, cur, acc, mode=0 if blk == 0 else 1)
            else:
                conv(src, w, b, k, dil, cur, acc, mode=2, out_ptr=out.data_ptr())

    if post is None:
        return out
    w_p, b_p = post
    kp, _, cp = w_p.shape
    wave = torch.empty(B, L, cp, **f32)
    _build.check(
        lib.viettts_mrf_post(
            bf, out.data_ptr(), w_p.data_ptr(), b_p.data_ptr(), wave.data_ptr(),
            B, L, C, cp, kp, stream,
        ),
        "fused_mrf epilogue",
    )
    return wave


fused_mrf.launches = 0
fused_mrf.plain_calls = 0
