"""The port's corpus and checkpoint tools: ``tools.gta`` (GTA mels for
vocoder finetuning), ``tools.zero_silence_segments``,
``tools.convert_torch_hifigan`` (upstream PyTorch HiFi-GAN checkpoints to
native pickles), ``tools.denoise`` (spectral gating on the device, or
NSNet2), ``tools.align`` (corpus assembly and the Montreal Forced
Aligner) and ``tools.build_lexicon``; and its validation tools:
``tools.synth_corpus`` (the two synthetic corpora), ``tools.validate_gan``,
``tools.validate_int8``, ``tools.diagnose_int8`` and
``tools.validate_e2e_training``; and ``tools.multihost_dryrun`` (one FSDP
step over N processes and a sharded checkpoint round trip)."""
