"""The serving models a configuration runs, one module a model, found by
file: ``perfbench/reference/models/<name>.py`` for each name in the
configuration's ``"models": {"duration": ..., "acoustic": ..., "vocoder":
...}`` (a role left out takes ``viettts_duration``, ``viettts_acoustic`` or
``hifigan``).  A module is plain PyTorch, imports nothing of the program,
and holds all that the harness knows of its model:

* every role: ``leaves(sizes, gains)``, its seeded tree as
  ``perfbench.harness.weights.Leaf`` entries, paths inside its checkpoint;
* duration: ``durations(tree, sizes, tokens, lengths)`` (seconds [B, T])
  and ``flops(sizes, n_tokens, batch=1)``;
* acoustic: ``mel(tree, sizes, tokens, lengths, frames, n_frames, keep1,
  keep2, keep_prob)`` (log-mel [B, n_frames, D]),
  ``decode_flops(sizes, n_tokens, n_frames, batch=1)`` and
  ``ar_decode_counts(sizes, frames)`` (K1's FLOP and bytes);
* vocoder: ``wave(tree, sizes, mel, dtype)`` (waveform [B, n_frames * hop]
  at ``float32``, the stated ``bfloat16`` or the ``float8`` control),
  ``generator_flops(sizes, n_frames, batch=1, conv_pre=True)``,
  ``stage_counts(sizes, frames)`` and ``weight_bytes(sizes)`` (what the
  vocoder kernels read and compute).

``layers`` holds what several models share.
"""
