"""Reference-compatible CLI and text normalization over the port.

``python -m vietTTS.synthesizer --text ... --output ...`` behaves like the
reference command, running the port's Synthesizer on the float32 parity
route by default (``vietTTS.PARITY_CFG``; ``--set
hifigan.inference_dtype=bfloat16`` opts back into the fast route) and on
the card (``--device cpu`` runs the plain twins).
"""

import functools

from viettts_tpu_torch.synthesizer import main as _main
from viettts_tpu_torch.text import normalize_text as nat_normalize_text

main = functools.wraps(_main)(functools.partial(_main, default_overrides=("hifigan.inference_dtype=float32",)))

__all__ = ["main", "nat_normalize_text"]

if __name__ == "__main__":
    import sys

    sys.exit(main())
