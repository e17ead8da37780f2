"""The configuration tree (counterpart of ``viettts_tpu/config.py``).

``viettts_tpu.config`` is plain Python (dataclasses, no jax), so the port
shares it rather than keeping a second copy that could drift; this module
re-exports it under the port's own name.
"""

from viettts_tpu.config import (  # noqa: F401
    SIL_INDEX,
    WORD_END_INDEX,
    AcousticModelConfig,
    Config,
    DurationModelConfig,
    HifiGanConfig,
    apply_overrides,
)
