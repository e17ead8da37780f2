"""The port's benchmark programs, one per measuring program of the JAX
package, each at that program's shapes and widths:

* ``e2e`` (``bench.py``): end-to-end real-time factor, B=1, 256 tokens,
  1,024 frames;
* ``batch`` (``scripts/bench_batch.py``): a 64-utterance batch through the
  full pipeline and the vocoder alone;
* ``train`` (``scripts/bench_train.py``): the acoustic trainer's update
  and the HiFi-GAN step in float32 and mixed precision;
* ``vocoder_batch`` (``scripts/tune_vocoder_batch.py``): the float32 and
  bfloat16 vocoder routes per batch size;
* ``b1_vocoder`` (``scripts/bench_b1_vocoder.py``): the B=1 vocoder on the
  float32, bfloat16 and int8 routes.

Each runs on the card (``python -m viettts_tpu_torch.bench.<name>``),
prints the card's name and power limit, then one JSON line last, and
writes that JSON under ``runs/bench/`` (or ``--out``).  ``--device cpu``
runs the plain twins, for the tests.
"""
