"""Seeded checkpoints at a config's widths: numpy variable trees in the
JAX package's layout (what the Synthesizer's ``load_variables`` reads),
written as native pickles, for programs that serve a Synthesizer on random
weights (``bench.stream``, ``chip_smoke.py``, the timing scripts)."""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from viettts_tpu_torch.checkpoint import NATIVE_FORMAT, LSTMParams


def seeded(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _lstm(rng, d_in, h):
    s = (d_in + h) ** -0.5
    return LSTMParams(seeded(rng, d_in, 4 * h, scale=s), seeded(rng, h, 4 * h, scale=s), seeded(rng, 4 * h, scale=0.05))


def _dense(rng, i, o, bias=True):
    d = {"kernel": seeded(rng, i, o, scale=i ** -0.5)}
    if bias:
        d["bias"] = seeded(rng, o, scale=0.05)
    return d


def _conv(rng, k, i, o, gain=1.0):
    return {"kernel": seeded(rng, k, i, o, scale=gain * (k * i) ** -0.5), "bias": seeded(rng, o, scale=0.05)}


def _bn(rng, c):
    params = {"scale": 1.0 + seeded(rng, c, scale=0.1), "bias": seeded(rng, c, scale=0.05)}
    stats = {"mean": seeded(rng, c, scale=0.05), "var": np.abs(1.0 + seeded(rng, c, scale=0.1))}
    return params, stats


def _encoder(rng, vocab, C):
    p = {"embed": {"embedding": seeded(rng, vocab, C)}}
    s = {}
    for i in range(3):
        p[f"conv_{i}"] = _conv(rng, 3, C, C)
        p[f"bn_{i}"], s[f"bn_{i}"] = _bn(rng, C)
    p["lstm_fwd"], p["lstm_bwd"] = _lstm(rng, C, C), _lstm(rng, C, C)
    return p, s


def seeded_variables(cfg, seed=0):
    """Seeded numpy variable trees in the JAX package's layout for the
    three models of ``cfg``: weights at 1/sqrt(fan_in), BatchNorm near
    identity, and a duration-head bias of -2.5 so that tokens last about
    80 ms, a speaking pace."""
    rng = np.random.default_rng(seed)
    dc, ac, hc = cfg.duration, cfg.acoustic, cfg.hifigan

    enc_p, enc_s = _encoder(rng, dc.vocab_size, dc.lstm_dim)
    head = _dense(rng, dc.lstm_dim, 1)
    head["bias"] = np.full((1,), -2.5, np.float32)
    duration = {
        "params": {"encoder": enc_p, "proj_0": _dense(rng, 2 * dc.lstm_dim, dc.lstm_dim), "proj_1": head},
        "batch_stats": {"encoder": enc_s},
    }

    C, P, H, D = 2 * ac.encoder_dim, ac.prenet_dim, ac.decoder_dim, ac.mel_dim
    enc_p, enc_s = _encoder(rng, ac.vocab_size, ac.encoder_dim)
    params = {
        "encoder": enc_p,
        "decoder_lstm1": _lstm(rng, C + P, H),
        "decoder_lstm2": _lstm(rng, C + P + H, H),
        "prenet_fc1": _dense(rng, D, P, bias=False),
        "prenet_fc2": _dense(rng, P, P, bias=False),
        "projection": _dense(rng, 2 * H, D),
    }
    stats = {"encoder": enc_s}
    dims = [D] + [ac.postnet_dim] * 4 + [D]
    for i in range(5):
        params[f"postnet_conv_{i}"] = _conv(rng, 5, dims[i], dims[i + 1])
    for i in range(4):
        params[f"postnet_bn_{i}"], stats[f"postnet_bn_{i}"] = _bn(rng, ac.postnet_dim)
    acoustic = {"params": params, "batch_stats": stats}

    c0 = hc.upsample_initial_channel
    gen = {"conv_pre": _conv(rng, 7, hc.mel_dim, c0)}
    n = len(hc.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(hc.upsample_rates, hc.upsample_kernel_sizes)):
        ch = c0 // 2 ** (i + 1)
        gen[f"ups_{i}"] = {
            "kernel": seeded(rng, k, 2 * ch, ch, scale=(k * 2 * ch / u) ** -0.5),
            "bias": seeded(rng, ch, scale=0.05),
        }
        for j, (rk, rd) in enumerate(zip(hc.resblock_kernel_sizes, hc.resblock_dilation_sizes)):
            names = [f"convs1_{m}" for m in range(len(rd))] + [f"convs2_{m}" for m in range(len(rd))]
            gen[f"resblock_{i * n + j}"] = {nm: _conv(rng, rk, ch, ch, gain=0.5) for nm in names}
    gen["conv_post"] = _conv(rng, 7, c0 // 2 ** len(hc.upsample_rates), 1, gain=2.0)
    return {"duration": duration, "acoustic": acoustic, "hifigan": {"params": gen}}


def write_checkpoints(cfg, d: Path, seed: int = 0) -> None:
    """``seeded_variables(cfg, seed)`` as ``<d>/{duration,acoustic,hifigan}_latest_ckpt.pickle``."""
    for kind, variables in seeded_variables(cfg, seed).items():
        with open(d / f"{kind}_latest_ckpt.pickle", "wb") as f:
            pickle.dump({"format": NATIVE_FORMAT, "step": 0, "variables": variables}, f)
