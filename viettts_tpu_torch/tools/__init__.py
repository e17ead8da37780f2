"""The port's corpus and checkpoint tools: ``tools.gta`` (GTA mels for
vocoder finetuning), ``tools.zero_silence_segments`` and
``tools.convert_torch_hifigan`` (upstream PyTorch HiFi-GAN checkpoints to
native pickles)."""
