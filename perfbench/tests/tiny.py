"""Cells at tiny widths and short traffic, for the CPU tests: the program's
plain twins stand in for its kernels, and the lead program runs eagerly."""

import copy

from perfbench.harness import cells

TINY = {"duration.lstm_dim": 16, "acoustic.encoder_dim": 16, "acoustic.decoder_dim": 32, "acoustic.prenet_dim": 16,
        "acoustic.postnet_dim": 16, "hifigan.upsample_initial_channel": 32}
TRAFFIC = {
    "infore.bulk64": {"batch": 4, "tokens": {"median": 20, "sigma": 0.5, "min": 6, "max": 60}, "prepared_calls": 2,
                      "warmup": [{"batch_sizes": [4], "token_buckets": [64], "frame_buckets": [256]}]},
    "tacotron2.stream": {"tokens": {"median": 40, "sigma": 0.4, "min": 6, "max": 90, "pool": 32},
                         "prepared_streams": 4,
                         "warmup": [{"batch_sizes": [1], "token_buckets": [32, 64, 128, 192, 256]}]},
}


def tiny_cell(name: str) -> cells.Cell:
    c = cells.load(name)
    c.config = copy.deepcopy(c.config)
    c.config["sizes"].update(TINY)
    c.config["program_overrides"] = ["acoustic.fused_decode=false", "hifigan.fused_inference=false"]
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic.update(TRAFFIC[name])
    return c
