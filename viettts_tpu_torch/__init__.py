"""PyTorch/CUDA port of the Vietnamese TTS system: synthesis and serving,
the duration, acoustic and HiFi-GAN trainers and the corpus tools, on one
card or data-parallel over several (one process per card).

The package mirrors ``viettts_tpu``'s module layout (``ops/``, ``models/``,
``data/``, ``train/``, ``infer/``, ``parallel/``, ``tools/``, ``utils/``,
``synthesizer.py``, ``serve.py``) so each counterpart is easy to find.  It
imports ``torch`` and nothing of ``jax``, ``flax``, ``optax`` or the JAX
package: it keeps its own copies of the framework-free parts it needs
(``config.py``, ``text/``, ``audio.py``, the batcher and HTTP front end
in ``serve.py``), which the tests hold equal to the JAX package's.

On a CUDA device the hot loops run as hand-written CUDA kernels
(``csrc/ar_decoder.cu``, ``csrc/mrf.cu``, and ``csrc/mrf_int8.cu`` on the
int8 vocoder route), built with ``nvcc`` at first use; on CPU tensors the
same entry points run their plain PyTorch twins.
"""
