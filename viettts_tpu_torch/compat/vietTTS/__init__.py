"""Drop-in ``vietTTS`` import-path shim over the PyTorch port.

Lets code written against the reference (NTT123/vietTTS) run unchanged on
the card:

    PYTHONPATH=viettts_tpu_torch/compat python -m vietTTS.synthesizer --text "..." --output clip.wav

    from vietTTS.nat.text2mel import text2mel
    from vietTTS.hifigan.mel2wave import mel2wave

The counterpart of ``compat/vietTTS``, which serves the JAX package and
which an install of the repository maps onto the import path; this one is
reached by putting this directory, ``viettts_tpu_torch/compat``, on the
path (it is not a package of the port, so it never shadows either).  The
implementations are the port's (cached Synthesizers, bucketed shapes, the
hand-written kernels); only the import paths and signatures are the
reference's.

Every entry point serves through ``PARITY_CFG``, the default config with
the float32 vocoder route: the drop-in surface promises reference parity
(``<=1e-3`` waveform agreement, BASELINE.json), which the bf16 serving
default would break for a user who never opted in.  The free functions
run on ``DEVICE`` (``"cuda"``: the port has no device fallback); set it
to ``"cpu"`` to run the plain twins.
"""

from viettts_tpu_torch.config import DEFAULT_CONFIG, apply_overrides

#: Reference-parity serving config: float32 vocoder route.
PARITY_CFG = apply_overrides(DEFAULT_CONFIG, ["hifigan.inference_dtype=float32"])
#: The device ``text2mel`` and ``mel2wave`` run on.
DEVICE = "cuda"

__all__ = ["PARITY_CFG", "DEVICE"]
