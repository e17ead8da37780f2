"""Offline corpus denoiser (counterpart of ``viettts_tpu/tools/denoise.py``).

The reference prepares the InfoRe corpus by running Microsoft's NSNet2
noise suppressor over every clip before alignment (its
``notebooks/denoise_infore_dataset.ipynb``, cells 4-6).  This tool makes
that step runnable without the notebook:

* With an NSNet2 ONNX model (``--nsnet2 model.onnx``) and onnxruntime
  importable, it runs that suppressor, on the host as the JAX package
  does; onnxruntime is imported only then.
* Otherwise it applies **spectral gating**: a per-frequency noise floor
  from the quietest frames, a soft (Wiener-like) magnitude mask, and
  overlap-add resynthesis, in float64 torch on ``--device`` (default
  ``cuda``; ``--device cpu`` on the host).  The STFT is the JAX tool's
  numpy one written out in torch (reflect padding, Hann framing,
  ``rfft``/``irfft``, windowed overlap-add), so the two agree to float64
  rounding; the quiet frames are picked by a stable sort.

CLI::

    python -m viettts_tpu_torch.tools.denoise -i wav_dir -o out_dir \\
        [--strength 2.0] [--nsnet2 nsnet2.onnx] [--device cpu]
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from viettts_tpu_torch.audio import read_wav, write_wav


def _hann(n_fft: int, device) -> torch.Tensor:
    """numpy's periodic Hann window, ``np.hanning(n_fft + 1)[:-1]``."""
    return torch.from_numpy(np.hanning(n_fft + 1)[:-1]).to(device)


def _frame_index(n_frames: int, n_fft: int, hop: int, device) -> torch.Tensor:
    return (torch.arange(n_fft, device=device)[None, :] + hop * torch.arange(n_frames, device=device)[:, None])


def _stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[S] float64 -> [frames, n_fft//2+1] complex128 (Hann, centred by
    numpy's reflect padding)."""
    pad = torch.from_numpy(np.pad(np.arange(x.shape[0]), n_fft // 2, mode="reflect")).to(x.device)
    xp = x[pad]
    n_frames = 1 + (xp.shape[0] - n_fft) // hop
    return torch.fft.rfft(xp[_frame_index(n_frames, n_fft, hop, x.device)] * _hann(n_fft, x.device), dim=-1)


def _istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """Inverse of :func:`_stft` by windowed overlap-add."""
    window = _hann(n_fft, spec.device)
    n_frames = spec.shape[0]
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    idx = _frame_index(n_frames, n_fft, hop, spec.device).reshape(-1)
    size = (n_frames - 1) * hop + n_fft
    out = frames.new_zeros(size).index_add_(0, idx, frames.reshape(-1))
    norm = frames.new_zeros(size).index_add_(0, idx, (window * window).expand(n_frames, n_fft).reshape(-1))
    out = out / torch.clamp(norm, min=1e-8)
    return out[n_fft // 2 : n_fft // 2 + length]


def spectral_gate(
    wav: np.ndarray,
    sample_rate: int,
    n_fft: int = 1024,
    hop: int = 256,
    strength: float = 2.0,
    quiet_frac: float = 0.1,
    floor_db: float = -24.0,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Stationary-noise spectral gating on ``device``; float32 samples out.

    The per-frequency noise floor is the mean spectrum of the quietest
    ``quiet_frac`` of frames by broadband energy.  Each bin is attenuated
    by a soft mask that approaches 1 above ``strength`` x floor and
    ``floor_db`` below it, smoothed over 3 frames against musical noise.
    """
    x = torch.from_numpy(np.asarray(wav, np.float64)).to(device)
    scale = torch.clamp(x.abs().max(), min=1e-8)
    spec = _stft(x / scale, n_fft, hop)
    mag = spec.abs()
    energy = mag.mean(dim=1)
    k = max(1, int(energy.shape[0] * quiet_frac))
    quiet = torch.sort(energy, stable=True).indices[:k]
    noise = mag[quiet].mean(dim=0, keepdim=True)
    thresh = strength * torch.clamp(noise, min=1e-10)
    gate = 1.0 / (1.0 + torch.exp(-4.0 * (mag / thresh - 1.0)))  # ~6 dB wide
    min_gain = 10.0 ** (floor_db / 20.0)
    g = min_gain + (1.0 - min_gain) * gate
    g = (torch.cat([g[:1], g[:-1]]) + g + torch.cat([g[1:], g[-1:]])) / 3.0
    out = _istft(spec * g, n_fft, hop, x.shape[0]) * scale
    return out.to(torch.float32).cpu().numpy()


def nsnet2_denoise(wav: np.ndarray, sample_rate: int, model_path: str | Path) -> np.ndarray:
    """The NSNet2 ONNX suppressor (the reference notebook's model), on the
    host: log-power features at a 160-sample hop, a per-frame gain on the
    STFT.  Needs onnxruntime and the published NSNet2 baseline model."""
    import onnxruntime as ort  # only with a model file

    n_fft, hop = 512, 160  # the NSNet2 baseline's 16 kHz frames
    x = wav.astype(np.float32) / 32768.0 if wav.dtype == np.int16 else wav
    spec = _stft(torch.from_numpy(np.asarray(x, np.float64)), n_fft, hop)
    feat = torch.log10(torch.clamp(spec.abs() ** 2, min=1e-12)).to(torch.float32).numpy()
    sess = ort.InferenceSession(str(model_path))
    gain = sess.run(None, {sess.get_inputs()[0].name: feat[None]})[0][0]
    out = _istft(spec * torch.from_numpy(np.clip(gain, 0.0, 1.0)), n_fft, hop, len(x))
    return out.to(torch.float32).numpy()


def denoise_file(src: Path, dst: Path, strength: float = 2.0, nsnet2: Optional[Path] = None,
                 device: str | torch.device = "cuda") -> None:
    sr, data = read_wav(src)
    if data.ndim > 1:
        data = data.mean(axis=-1)
    x = data.astype(np.float32)
    if data.dtype == np.int16:
        x = x / 32768.0
    if nsnet2 is not None:
        y = nsnet2_denoise(x, sr, nsnet2)
    else:
        y = spectral_gate(x, sr, strength=strength, device=device)
    write_wav(dst, np.clip(y, -1.0, 1.0), sr)


def main(argv=None):
    parser = ArgumentParser(description="Denoise a directory of WAV files")
    parser.add_argument("-i", "--input-dir", type=Path, required=True)
    parser.add_argument("-o", "--output-dir", type=Path, required=True)
    parser.add_argument("--strength", type=float, default=2.0, help="noise-floor multiplier for the spectral gate")
    parser.add_argument("--nsnet2", type=Path, default=None, help="optional NSNet2 ONNX model (needs onnxruntime)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the spectral gate (default cuda; cpu on the host)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; pass --device cpu")
    args.output_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(args.input_dir.glob("*.wav"))
    if not files:
        raise SystemExit(f"no .wav files in {args.input_dir}")
    for i, f in enumerate(files):
        denoise_file(f, args.output_dir / f.name, args.strength, args.nsnet2, device)
        if (i + 1) % 100 == 0 or i + 1 == len(files):
            print(f"{i + 1}/{len(files)} denoised")


if __name__ == "__main__":
    main()
