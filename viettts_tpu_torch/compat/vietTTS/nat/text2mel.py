"""Reference-compatible ``text2mel`` over the port.

Same signature as the reference's (``lexicon_fn`` is a lexicon file
path); backed by the port's cached Synthesizer on ``vietTTS.DEVICE`` with
``vietTTS.PARITY_CFG`` (the float32 vocoder route), so repeated calls
never reload checkpoints.
"""

import numpy as np

import vietTTS
from viettts_tpu_torch import infer as _infer


def text2mel(text: str, lexicon_fn=None, silence_duration: float = -1.0) -> np.ndarray:
    synth = _infer.get_synthesizer(
        cfg=vietTTS.PARITY_CFG, device=vietTTS.DEVICE,
        **({"lexicon_file": lexicon_fn} if lexicon_fn else {}),
    )
    return synth.synthesize(text, silence_duration).mel


__all__ = ["text2mel"]
