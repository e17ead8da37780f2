"""The port's log-mel front-end and mel-cepstral distortion against the JAX
package's, on the CPU, at the default DSP widths (16 kHz, n_fft 1024, hop
256, 80 mels).  Seeded numpy waveforms, one row ending in zeros.

Tolerances: mel (before the log) 1e-5 relative; log-mel 1e-3 absolute;
MCD 1e-4 dB.  Both sides run the DFT as float32 matmuls, summed in
different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viettts_tpu.config import DspConfig as JaxDsp
from viettts_tpu.ops import mel as jax_mel
from viettts_tpu.utils import metrics as jax_metrics
from viettts_tpu_torch.config import DspConfig
from viettts_tpu_torch.ops import mel
from viettts_tpu_torch.utils import metrics

CFG = DspConfig()


def _waves(seed, B=3, S=256 * 40):
    """Speech-like rows: harmonics with noise, one row zero-padded past
    60% of its length, all in [-1, 1]."""
    rng = np.random.RandomState(seed)
    t = np.arange(S) / CFG.sample_rate
    rows = []
    for _ in range(B):
        f0 = rng.uniform(100, 300)
        y = sum(rng.uniform(0.1, 0.4) * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) for h in (1, 2, 3, 5))
        rows.append(y + 0.05 * rng.randn(S))
    y = np.stack(rows).astype(np.float32) / 2
    y[-1, int(0.6 * S):] = 0.0
    return y


def test_filterbank_window_and_basis_match_jax():
    np.testing.assert_array_equal(
        mel.mel_filterbank(16000, 1024, 80, 0.0, 8000.0), jax_mel.mel_filterbank(16000, 1024, 80, 0.0, 8000.0)
    )
    np.testing.assert_array_equal(mel.hann_window(1024), jax_mel.hann_window(1024))
    for got, want in zip(mel._dft_basis(1024, 800), jax_mel._dft_basis(1024, 800)):
        np.testing.assert_array_equal(got, want)


def test_frame_signal_matches_jax():
    y = np.arange(2 * 3000, dtype=np.float32).reshape(2, 3000)
    want = np.asarray(jax_mel.frame_signal(jnp.asarray(y), 1024, 256))
    np.testing.assert_array_equal(mel.frame_signal(torch.from_numpy(y), 1024, 256).numpy(), want)
    want = np.asarray(jax_mel.frame_signal(jnp.asarray(y), 1000, 300))  # the strided fallback
    np.testing.assert_array_equal(mel.frame_signal(torch.from_numpy(y), 1000, 300).numpy(), want)


@pytest.mark.parametrize("center", [True, False])
def test_stft_magnitude_matches_jax(center):
    y = _waves(0)
    want = np.asarray(jax_mel.stft_magnitude(jnp.asarray(y), 1024, 256, 1024, center))
    got = mel.stft_magnitude(torch.from_numpy(y), 1024, 256, 1024, center).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_log_mel_matches_jax():
    y = _waves(1)
    want = np.asarray(jax_mel.LogMelSpectrogram(JaxDsp())(jnp.asarray(y)))
    got = mel.LogMelSpectrogram(CFG)(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == (3, y.shape[1] // CFG.hop_length, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(_mel(y, CFG, torch), _mel(y, JaxDsp(), jnp), rtol=1e-5, atol=0)


def _mel(y, cfg, xp):
    """Mel magnitudes of either side's front-end, before the log: its own
    framing, DFT basis and filterbank, the same numbers the log-mel uses."""
    p = (cfg.n_fft - cfg.hop_length) // 2
    if xp is torch:
        m = mel.LogMelSpectrogram(cfg)
        t = torch.nn.functional.pad(torch.from_numpy(y)[:, None], (p, p), mode="reflect")[:, 0]
        f = mel.frame_signal(t, cfg.n_fft, cfg.hop_length)
        re, im = f @ m.cos_b, f @ m.sin_b
        return (torch.sqrt(re * re + im * im + cfg.mag_eps) @ m.melfb_t).numpy()
    m = jax_mel.LogMelSpectrogram(cfg)
    t = jnp.pad(jnp.asarray(y), ((0, 0), (p, p)), mode="reflect")
    f = jax_mel.frame_signal(t, cfg.n_fft, cfg.hop_length)
    hi = jax_mel._matmul_f32
    re, im = hi(f, jnp.asarray(m._cos_b)), hi(f, jnp.asarray(m._sin_b))
    return np.asarray(hi(jnp.sqrt(re * re + im * im + cfg.mag_eps), jnp.asarray(m._melfb_t)))


def test_default_width_row_gives_768_frames():
    y = torch.zeros(1, 196_608)
    assert mel.LogMelSpectrogram(CFG)(y).shape == (1, 768, 80)


@pytest.mark.parametrize("n_coeffs", [13, 20])
def test_mel_cepstral_distortion_matches_jax(n_coeffs):
    fn = mel.LogMelSpectrogram(CFG)
    a = fn(torch.from_numpy(_waves(2))).numpy()
    b = a + 0.3 * np.random.RandomState(3).randn(*a.shape).astype(np.float32)
    np.testing.assert_array_equal(metrics._dct_matrix(80, n_coeffs), jax_metrics._dct_matrix(80, n_coeffs))
    np.testing.assert_allclose(
        metrics.mel_cepstra(torch.from_numpy(a), n_coeffs).numpy(),
        np.asarray(jax_metrics.mel_cepstra(jnp.asarray(a), n_coeffs)), rtol=1e-5, atol=1e-5,
    )
    got = float(metrics.mel_cepstral_distortion(torch.from_numpy(a), torch.from_numpy(b), n_coeffs))
    want = float(jax_metrics.mel_cepstral_distortion(jnp.asarray(a), jnp.asarray(b), n_coeffs))
    assert abs(got - want) <= 1e-4 and want > 1.0
    assert float(metrics.mel_cepstral_distortion(torch.from_numpy(a), torch.from_numpy(a))) < 1e-4
