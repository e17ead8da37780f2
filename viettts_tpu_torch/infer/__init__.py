"""Inference API (counterpart of ``viettts_tpu/infer/__init__.py``).

``Synthesizer`` is the primary interface.  ``text2mel`` / ``mel2wave``
mirror the reference's free-function API on top of a lazily constructed
Synthesizer, cached per constructor kwargs.  There is no device
auto-selection: the free functions default to ``device="cuda"`` and fail
when no GPU is available.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from viettts_tpu_torch.infer.pipeline import SynthesisResult, Synthesizer

_CACHE: Dict[Tuple, Synthesizer] = {}


def _cache_key(kwargs: dict) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in kwargs.items()))


def get_synthesizer(**kwargs) -> Synthesizer:
    """Return a (cached) Synthesizer; calls with the same kwargs share one
    instance.  ``device`` defaults to ``"cuda"``."""
    kwargs.setdefault("device", "cuda")
    key = _cache_key(kwargs)
    synth = _CACHE.get(key)
    if synth is None:
        synth = _CACHE[key] = Synthesizer(**kwargs)
    return synth


def clear_synthesizer_cache() -> None:
    _CACHE.clear()


def text2mel(
    text: str, lexicon_file=None, silence_duration: float = -1.0, device: str = "cuda"
) -> np.ndarray:
    """Text -> log-mel [T, mel_dim] (reference-compatible free function)."""
    kwargs = {"device": device}
    if lexicon_file:
        kwargs["lexicon_file"] = lexicon_file
    return get_synthesizer(**kwargs).synthesize(text, silence_duration).mel


def mel2wave(mel: np.ndarray, device: str = "cuda") -> np.ndarray:
    """Log-mel [T, mel_dim] or [1, T, mel_dim] -> waveform [S] float32."""
    mel = np.asarray(mel)
    if mel.ndim == 2:
        mel = mel[None]
    return get_synthesizer(device=device).vocode(mel)[0]


__all__ = [
    "Synthesizer",
    "SynthesisResult",
    "get_synthesizer",
    "clear_synthesizer_cache",
    "text2mel",
    "mel2wave",
]
