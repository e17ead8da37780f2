"""16-bit PCM WAV I/O of the port: ``read_wav`` and ``write_wav`` (as
``viettts_tpu/data/audio.py`` reads and writes them) and the server's
in-memory ``wav_bytes``.  Float samples are clipped to [-1, 1] and scaled
by 32767, truncating."""

from __future__ import annotations

import io
import wave
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path: str | Path) -> Tuple[int, np.ndarray]:
    """Read a WAV file -> (sample_rate, samples [S] or [S, C]) through
    scipy when it reads the file, else as 16-bit PCM with ``wave``."""
    try:
        from scipy.io import wavfile

        sr, data = wavfile.read(str(path))
        return int(sr), np.asarray(data)
    except Exception:
        with wave.open(str(path), "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(n)
        if width != 2:
            raise ValueError(f"only 16-bit PCM supported, got width={width}")
        data = np.frombuffer(raw, dtype="<i2")
        if ch > 1:
            data = data.reshape(-1, ch)
        return sr, data


def pcm16(wave_f32) -> np.ndarray:
    """A float waveform in [-1, 1] as little-endian int16 samples."""
    return (np.clip(np.asarray(wave_f32), -1.0, 1.0) * 32767.0).astype("<i2")


def _write(target, pcm: np.ndarray, sample_rate: int) -> None:
    with wave.open(target, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def write_wav(path: str | Path, data, sample_rate: int) -> None:
    """Write mono 16-bit PCM.  Float input in [-1, 1] is converted; integer
    input is cast to int16."""
    data = np.asarray(data)
    _write(str(path), pcm16(data) if data.dtype.kind == "f" else data.astype("<i2"), sample_rate)


def wav_bytes(wave_f32, sample_rate: int) -> bytes:
    """Mono 16-bit PCM WAV file contents of a float waveform in [-1, 1]."""
    buf = io.BytesIO()
    _write(buf, pcm16(wave_f32), sample_rate)
    return buf.getvalue()
