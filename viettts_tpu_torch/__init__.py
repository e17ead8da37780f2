"""PyTorch/CUDA port of the Vietnamese TTS inference path.

The package mirrors ``viettts_tpu``'s module layout (``ops/``, ``models/``,
``infer/``, ``synthesizer.py``) so each counterpart is easy to find.  It
imports ``torch`` and never ``jax``, ``flax`` or ``optax``; the
framework-free parts of the JAX package (``viettts_tpu.config``,
``viettts_tpu.text``, ``viettts_tpu.data.audio``) are reused by import.

On a CUDA device the two hot loops run as hand-written CUDA kernels
(``csrc/ar_decoder.cu``, ``csrc/mrf.cu``), built with ``nvcc`` at first
use; on CPU tensors the same entry points run their plain PyTorch twins.
"""
