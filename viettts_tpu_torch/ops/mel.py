"""Log-mel spectrogram front-end (counterpart of ``viettts_tpu/ops/mel.py``).

Numerics are the JAX package's: reflect padding of ``(n_fft - hop) / 2``,
center=False framing, the one-sided DFT of Hann-windowed frames as two
float32 matmuls against precomputed ``cos``/``-sin`` bases, magnitude
``sqrt(re^2 + im^2 + 1e-9)``, a Slaney-normalized mel filterbank (the
port's own numpy copy, librosa-compatible) and ``log(clip(mel, 1e-5))``.
The matmuls run in full float32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays off (its default); no
kernel of the port sits here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.config import DspConfig


def _hz_to_mel(freq) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        freq / f_sp,
    )


def _mel_to_hz(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), mels * f_sp
    )


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, n_fft // 2 + 1]
    (``librosa.filters.mel(htk=False, norm="slaney")``)."""
    if fmax is None:
        fmax = sample_rate / 2
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (``np.hanning(N + 1)[:-1]``)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _dft_basis(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases, each [n_fft, n_fft // 2 + 1]:
    ``frames @ cos_b`` and ``frames @ sin_b`` are the real and imaginary
    parts of the one-sided DFT of the Hann-windowed frames."""
    window = hann_window(win_length)
    pad = (n_fft - win_length) // 2
    if pad > 0:
        window = np.pad(window, (pad, pad))
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(1 + n_fft // 2, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """[B, S] signals -> [B, (S - frame_length) // hop + 1, frame_length]
    frames (a strided view)."""
    return y.unfold(-1, frame_length, hop_length)


def stft_magnitude(
    y: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    center: bool = True,
    pad_mode: str = "reflect",
    mag_eps: float = 1e-9,
) -> torch.Tensor:
    """Magnitude STFT of [B, S] -> [B, T, n_fft // 2 + 1], Hann window;
    ``center=True`` pads by ``n_fft // 2`` on both sides like librosa."""
    cos_b, sin_b = (torch.from_numpy(b).to(y.device) for b in _dft_basis(n_fft, win_length))
    if center:
        y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode=pad_mode)[:, 0]
    frames = frame_signal(y, n_fft, hop_length)
    real, imag = frames @ cos_b, frames @ sin_b
    return torch.sqrt(real * real + imag * imag + mag_eps)


class LogMelSpectrogram(nn.Module):
    """Waveform [B, S] (float in [-1, 1]) -> log-mel [B, S // hop, n_mels]."""

    def __init__(self, cfg: DspConfig):
        super().__init__()
        self.cfg = cfg
        melfb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.mel_dim, cfg.fmin, cfg.fmax)
        cos_b, sin_b = _dft_basis(cfg.n_fft, cfg.win_length)
        self.register_buffer("melfb_t", torch.from_numpy(np.ascontiguousarray(melfb.T)), persistent=False)
        self.register_buffer("cos_b", torch.from_numpy(cos_b), persistent=False)
        self.register_buffer("sin_b", torch.from_numpy(sin_b), persistent=False)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if y.dim() != 2:
            raise ValueError(f"expected [B, S] waveforms, got {tuple(y.shape)}")
        p = (cfg.n_fft - cfg.hop_length) // 2
        y = F.pad(y[:, None], (p, p), mode="reflect")[:, 0]
        frames = frame_signal(y, cfg.n_fft, cfg.hop_length)
        real, imag = frames @ self.cos_b, frames @ self.sin_b
        mag = torch.sqrt(real * real + imag * imag + cfg.mag_eps)
        return torch.log(torch.clamp(mag @ self.melfb_t, min=cfg.mel_min_clip))
