"""Reference-compatible ``mel2wave`` over the port's vocoder (kernel K2 on
the float32 route, ``vietTTS.PARITY_CFG``, on ``vietTTS.DEVICE``)."""

import numpy as np

import vietTTS
from viettts_tpu_torch import infer as _infer


def mel2wave(mel: np.ndarray) -> np.ndarray:
    synth = _infer.get_synthesizer(cfg=vietTTS.PARITY_CFG, device=vietTTS.DEVICE)
    mel = np.asarray(mel)
    if mel.ndim == 2:
        mel = mel[None]
    return synth.vocode(mel)[0]


__all__ = ["mel2wave"]
