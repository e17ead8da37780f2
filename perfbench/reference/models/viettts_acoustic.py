"""vietTTS's acoustic model at inference (``nat/model.py``): the token
encoder, Gaussian upsampling (``softmax(-(mid - f)^2 / sigma2)`` over the
row's tokens), a prenet of two bias-free dense + relu layers with dropout
masks kept on at inference, two LSTM layers fed [context, prenet] and
[context, prenet, h1], the [h1, h2] projection fed back, then the 5-conv
postnet (k=5, BatchNorm and tanh on the first 4) added as a residual.
Seeded as ``bench/seeded.py`` lays it out.  Its fed-back decode is the
program's kernel K1, whose counts ``ar_decode_counts`` gives.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.harness.weights import Leaf
from perfbench.reference.models import layers


def leaves(sizes: Dict[str, object], gains: Dict[str, float]) -> List[Leaf]:
    C, P = 2 * sizes["acoustic.encoder_dim"], sizes["acoustic.prenet_dim"]
    H, D, Q = sizes["acoustic.decoder_dim"], sizes["acoustic.mel_dim"], sizes["acoustic.postnet_dim"]
    out = layers.encoder_leaves(sizes["acoustic.vocab_size"], sizes["acoustic.encoder_dim"])
    p = ("params",)
    out += layers.lstm_leaves(p + ("decoder_lstm1",), C + P, H) + layers.lstm_leaves(p + ("decoder_lstm2",), C + P + H, H)
    out += layers.dense_leaves(p + ("prenet_fc1",), D, P, bias=False) + layers.dense_leaves(p + ("prenet_fc2",), P, P,
                                                                                          bias=False)
    out += layers.dense_leaves(p + ("projection",), 2 * H, D)
    dims = [D] + [Q] * 4 + [D]
    for i in range(5):
        out += layers.conv_leaves(p + (f"postnet_conv_{i}",), 5, dims[i], dims[i + 1])
    for i in range(4):
        out += layers.bn_leaves(p + (f"postnet_bn_{i}",), ("batch_stats", f"postnet_bn_{i}"), Q)
    return out


def mel(tree, sizes, tokens, lengths, frames, n_frames: int, keep1, keep2, keep_prob: float) -> torch.Tensor:
    """Log-mel [B, n_frames, D] after the postnet.  ``frames`` [B, T] are
    the durations in frames; ``keep1``/``keep2`` [n_frames, B, P] the
    prenet's keep masks."""
    p, s = tree["params"], tree["batch_stats"]
    enc = layers.encoder(p["encoder"], s["encoder"], tokens, lengths)
    T = tokens.shape[1]
    end = torch.cumsum(frames, 1)
    mid = end - frames / 2.0
    f = torch.arange(n_frames, device=tokens.device, dtype=torch.float32)
    logits = -torch.square(mid[:, None, :] - f[None, :, None]) / sizes["acoustic.upsample_sigma2"]
    token_mask = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
    logits = logits.masked_fill(~token_mask[:, None, :], float("-inf"))
    cond = torch.softmax(logits, -1) @ enc  # [B, L, C]
    C, P = cond.shape[-1], p["prenet_fc2"]["kernel"].shape[0]
    l1, l2 = p["decoder_lstm1"], p["decoder_lstm2"]
    g1c = cond @ l1["w_i"][:C] + l1["b"]
    g2c = cond @ l2["w_i"][:C] + l2["b"]
    w1p, w2p, w2h1 = l1["w_i"][C:], l2["w_i"][C:C + P], l2["w_i"][C + P:]
    B, H = tokens.shape[0], l1["w_h"].shape[0]
    h1, c1, h2, c2 = (cond.new_zeros(B, H) for _ in range(4))
    mel = cond.new_zeros(B, p["projection"]["kernel"].shape[1])
    scale = 1.0 / keep_prob
    out = []
    for t in range(n_frames):
        q = torch.relu(mel @ p["prenet_fc1"]["kernel"]) * keep1[t] * scale
        q = torch.relu(q @ p["prenet_fc2"]["kernel"]) * keep2[t] * scale
        h1, c1 = layers.lstm_cell(g1c[:, t] + q @ w1p + h1 @ l1["w_h"], c1)
        h2, c2 = layers.lstm_cell(g2c[:, t] + q @ w2p + h1 @ w2h1 + h2 @ l2["w_h"], c2)
        mel = torch.cat([h1, h2], -1) @ p["projection"]["kernel"] + p["projection"]["bias"]
        out.append(mel)
    mel = torch.stack(out, 1).float()
    x = mel.transpose(1, 2)
    for i in range(5):
        x = layers.conv(x, p[f"postnet_conv_{i}"])
        if i < 4:
            x = torch.tanh(layers.batch_norm(x, p[f"postnet_bn_{i}"], s[f"postnet_bn_{i}"]))
    return mel + x.float().transpose(1, 2)


def decode_flops(sizes, n_tokens, n_frames, batch=1):
    """Operations for a row of ``n_tokens`` tokens decoded for ``n_frames``
    frames (``utils/flops.py``'s ``acoustic_decode_flops``)."""
    E, P, H = sizes["acoustic.encoder_dim"], sizes["acoustic.prenet_dim"], sizes["acoustic.decoder_dim"]
    D, Q = sizes["acoustic.mel_dim"], sizes["acoustic.postnet_dim"]
    enc_out = 2 * E
    f = layers.encoder_flops(n_tokens, E, batch)
    f += 2 * batch * n_frames * n_tokens * (1 + enc_out)
    f += layers.dense_flops(n_frames, D, P, batch) + layers.dense_flops(n_frames, P, P, batch)
    f += layers.lstm_flops(n_frames, P + enc_out, H, batch)
    f += layers.lstm_flops(n_frames, H + enc_out, H, batch)
    f += layers.dense_flops(n_frames, H + enc_out, D, batch)
    f += (layers.conv1d_flops(n_frames, D, Q, 5, batch) + 3 * layers.conv1d_flops(n_frames, Q, Q, 5, batch)
          + layers.conv1d_flops(n_frames, Q, D, 5, batch))
    return f


def ar_decode_counts(sizes, frames: int):
    """(FLOP, bytes) of K1 for ``frames`` frames of one launch: 2 FLOP a
    weight a frame; every weight read once, both gate tensors, both keep
    masks and the mel moved once a frame (``ar_decode_bound``'s count)."""
    H, P, D = sizes["acoustic.decoder_dim"], sizes["acoustic.prenet_dim"], sizes["acoustic.mel_dim"]
    weights = D * P + P * P + (P + H) * 4 * H + (P + 2 * H) * 4 * H + 2 * H * D + D
    flop = 2.0 * (weights - D) * frames
    bytes_ = 4 * weights + 2 * 4 * frames * 4 * H + 2 * frames * P + 4 * frames * D
    return flop, bytes_
