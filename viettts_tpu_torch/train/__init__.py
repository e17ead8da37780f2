"""The port's trainers: ``python -m viettts_tpu_torch.train.duration``,
``python -m viettts_tpu_torch.train.acoustic`` and
``python -m viettts_tpu_torch.train.hifigan``."""
