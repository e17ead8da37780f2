"""The port's trainers: ``python -m viettts_tpu_torch.train.duration`` and
``python -m viettts_tpu_torch.train.acoustic``."""
