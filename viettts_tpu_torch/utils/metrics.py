"""Mel-cepstral distortion (counterpart of ``viettts_tpu/utils/metrics.py``):
the standard compact spectral-envelope distance between time-aligned
log-mel spectrograms, used to track vocoder and acoustic quality."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=8)
def _dct_matrix(n_mels: int, n_coeffs: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_mels, n_coeffs] (scipy's norm='ortho'),
    mapping log-mel bands to cepstra."""
    k = np.arange(n_coeffs)[None, :]
    m = np.arange(n_mels)[:, None]
    basis = np.cos(np.pi * k * (2 * m + 1) / (2 * n_mels))
    basis *= np.sqrt(2.0 / n_mels)
    basis[:, 0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def mel_cepstra(log_mel: torch.Tensor, n_coeffs: int = 13) -> torch.Tensor:
    """Log-mel [..., T, n_mels] -> cepstra [..., T, n_coeffs] (c0 included)."""
    basis = torch.from_numpy(_dct_matrix(log_mel.shape[-1], n_coeffs)).to(log_mel.device)
    return log_mel @ basis


def mel_cepstral_distortion(
    log_mel_ref: torch.Tensor, log_mel_gen: torch.Tensor, n_coeffs: int = 13
) -> torch.Tensor:
    """MCD in dB between time-aligned log-mels [..., T, M]:
    ``(10 / ln 10) * sqrt(2) * mean_t ||c_ref[t] - c_gen[t]||_2`` over
    cepstral coefficients 1..n_coeffs-1 (c0, the energy, excluded)."""
    c_r = mel_cepstra(log_mel_ref, n_coeffs)[..., 1:]
    c_g = mel_cepstra(log_mel_gen, n_coeffs)[..., 1:]
    dist = torch.sqrt(torch.sum(torch.square(c_r - c_g), dim=-1) + 1e-12)
    return (10.0 / math.log(10.0)) * math.sqrt(2.0) * torch.mean(dist)
