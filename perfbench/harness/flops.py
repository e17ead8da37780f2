"""The yardstick: operation and byte counts of the serving models and the
card's peaks.

Frozen copy of ``viettts_tpu_torch/utils/flops.py`` (``Peaks``,
``H100_SXM``, ``H100_PCIE``, ``peaks_for_name``, ``duration_flops``,
``acoustic_decode_flops``, ``generator_flops``, the operation and byte
count of ``ar_decode_bound`` and the stage bytes of ``mrf_bound``), which the
repository's tests hold to the JAX package's counts.  A copy, so that a
change to the program cannot move what it is measured against.  Counts are
of what the inputs need: 2 FLOP a multiply-add, element-wise work left out.
``sizes`` are a configuration file's keys.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence


class Peaks(NamedTuple):
    name: str
    bf16: float
    tf32: float
    fp32: float  # outside the tensor cores
    int8: float
    fp64_tensor: float
    hbm_bytes_per_s: float
    sm_count: int


# NVIDIA H100 data sheets, dense
H100_SXM = Peaks("H100 SXM", 989e12, 495e12, 67e12, 1979e12, 67e12, 3.35e12, 132)
H100_PCIE = Peaks("H100 PCIe", 756e12, 378e12, 51e12, 1513e12, 51e12, 2.0e12, 114)


def peaks_for_name(name: str) -> Peaks:
    """The peaks of a card as ``torch.cuda.get_device_name`` names it; raises
    on a card whose peaks are not known."""
    n = name.lower()
    if "h100" in n and "pcie" in n:
        return H100_PCIE
    if "h100" in n and ("hbm3" in n or "sxm" in n):
        return H100_SXM
    raise ValueError(f"no peaks known for {name!r} (known: NVIDIA H100 SXM, NVIDIA H100 PCIe)")


def _conv1d(L, c_in, c_out, k, batch=1):
    return 2 * batch * L * c_in * c_out * k


def _dense(n, d_in, d_out, batch=1):
    return 2 * batch * n * d_in * d_out


def _lstm_steps(n, d_in, hidden, batch=1):
    return 2 * batch * n * 4 * hidden * (d_in + hidden)


def _encoder_flops(n_tokens, dim, batch=1):
    return 3 * _conv1d(n_tokens, dim, dim, 3, batch) + 2 * _lstm_steps(n_tokens, dim, dim, batch)


def duration_flops(sizes, n_tokens, batch=1):
    d = sizes["duration.lstm_dim"]
    return _encoder_flops(n_tokens, d, batch) + _dense(n_tokens, 2 * d, d, batch) + _dense(n_tokens, d, 1, batch)


def acoustic_decode_flops(sizes, n_tokens, n_frames, batch=1):
    E, P, H = sizes["acoustic.encoder_dim"], sizes["acoustic.prenet_dim"], sizes["acoustic.decoder_dim"]
    D, Q = sizes["acoustic.mel_dim"], sizes["acoustic.postnet_dim"]
    enc_out = 2 * E
    f = _encoder_flops(n_tokens, E, batch)
    f += 2 * batch * n_frames * n_tokens * (1 + enc_out)
    f += _dense(n_frames, D, P, batch) + _dense(n_frames, P, P, batch)
    f += _lstm_steps(n_frames, P + enc_out, H, batch)
    f += _lstm_steps(n_frames, H + enc_out, H, batch)
    f += _dense(n_frames, H + enc_out, D, batch)
    f += _conv1d(n_frames, D, Q, 5, batch) + 3 * _conv1d(n_frames, Q, Q, 5, batch) + _conv1d(n_frames, Q, D, 5, batch)
    return f


def generator_flops(sizes, n_frames, batch=1, conv_pre=True):
    """HiFi-GAN's operations for a mel of ``n_frames``; ``conv_pre=False``
    leaves out conv_pre, which runs outside the vocoder kernels."""
    C0, mel_dim = sizes["hifigan.upsample_initial_channel"], sizes["hifigan.mel_dim"]
    L = n_frames
    f = _conv1d(L, mel_dim, C0, 7, batch) if conv_pre else 0
    c_in = C0
    for i, (u, k) in enumerate(zip(sizes["hifigan.upsample_rates"], sizes["hifigan.upsample_kernel_sizes"])):
        c_out = C0 // (2 ** (i + 1))
        L *= u
        f += 2 * batch * L * c_in * c_out * (k / u)
        for rk, rd in zip(sizes["hifigan.resblock_kernel_sizes"], sizes["hifigan.resblock_dilation_sizes"]):
            f += len(rd) * 2 * _conv1d(L, c_out, c_out, rk, batch)
        c_in = c_out
    f += _conv1d(L, c_in, 1, 7, batch)
    return int(f)


def ar_decode_counts(sizes, frames: int):
    """(FLOP, bytes) of K1 for ``frames`` frames of one launch: 2 FLOP a
    weight a frame; every weight read once, both gate tensors, both keep
    masks and the mel moved once a frame."""
    H, P, D = sizes["acoustic.decoder_dim"], sizes["acoustic.prenet_dim"], sizes["acoustic.mel_dim"]
    weights = D * P + P * P + (P + H) * 4 * H + (P + 2 * H) * 4 * H + 2 * H * D + D
    flop = 2.0 * (weights - D) * frames
    bytes_ = 4 * weights + 2 * 4 * frames * 4 * H + 2 * frames * P + 4 * frames * D
    return flop, bytes_


def vocoder_stage_counts(sizes, frames: int, element_bytes: int = 2):
    """(FLOP, activation bytes) of the generator's stages (prologue, MRF
    convs, conv_post) for ``frames`` frames: each stage's input read and its
    output written once in the storage type."""
    flop = generator_flops(sizes, frames, conv_pre=False)
    C0 = sizes["hifigan.upsample_initial_channel"]
    rates = sizes["hifigan.upsample_rates"]
    bytes_, L, c_in = 0, frames, C0
    for i, u in enumerate(rates):
        c = C0 // 2 ** (i + 1)
        last = i == len(rates) - 1
        bytes_ += element_bytes * (L * c_in + L * u * (1 if last else c))
        L, c_in = L * u, c
    return float(flop), float(bytes_)


def vocoder_weight_bytes(sizes, element_bytes: int = 2) -> float:
    """Bytes of the stages' weights, read once a call."""
    C0 = sizes["hifigan.upsample_initial_channel"]
    n = 0
    for i, k in enumerate(sizes["hifigan.upsample_kernel_sizes"]):
        c = C0 // 2 ** (i + 1)
        n += k * 2 * c * c + c
        n += sum(len(d) * 2 * (rk * c * c + c) for rk, d in
                 zip(sizes["hifigan.resblock_kernel_sizes"], sizes["hifigan.resblock_dilation_sizes"]))
    n += 7 * (C0 // 2 ** len(sizes["hifigan.upsample_rates"])) + 1
    return float(element_bytes * n)


def bound_seconds(flop: float, bytes_: float, flops_per_s: float, peaks: Peaks) -> float:
    """The roofline: the larger of the operations at their peak and the
    bytes at the HBM rate."""
    return max(flop / flops_per_s, bytes_ / peaks.hbm_bytes_per_s)


def pipeline_flops(sizes, tokens: Sequence[int], frames: Sequence[int]) -> float:
    """Duration + decode + generator operations of rows of ``tokens`` tokens
    and ``frames`` kept frames."""
    return float(sum(duration_flops(sizes, t) + acoustic_decode_flops(sizes, t, f) + generator_flops(sizes, f)
                     for t, f in zip(tokens, frames)))
