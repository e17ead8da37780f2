"""Tacotron-2-style acoustic model, inference only (counterpart of
``viettts_tpu/models/acoustic.py``): aligned phonemes -> 80-bin log-mel.

TokenEncoder -> duration-driven Gaussian upsampling -> conditioning gates
for both decoder LSTM layers precomputed for all frames -> the
autoregressive decode (kernel K1, ``ops/ar_decoder.py``) -> postnet
residual.  Prenet dropout stays on at inference by default, as in the
reference; its keep-masks come from the caller or from a
``torch.Generator``.  The teacher-forced training forward is not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from viettts_tpu_torch.config import AcousticModelConfig
from viettts_tpu_torch.models.encoder import TokenEncoder
from viettts_tpu_torch.ops.ar_decoder import ar_decode
from viettts_tpu_torch.ops.rnn import LSTM


class AcousticModel(nn.Module):
    def __init__(self, cfg: AcousticModelConfig):
        super().__init__()
        self.cfg = cfg
        C, P, H, D = 2 * cfg.encoder_dim, cfg.prenet_dim, cfg.decoder_dim, cfg.mel_dim
        self.encoder = TokenEncoder(cfg.vocab_size, cfg.encoder_dim)
        self.lstm1 = LSTM(C + P, H)
        self.lstm2 = LSTM(C + P + H, H)
        # prenet layers have no bias; weights in the JAX [in, out] layout
        self.prenet_fc1 = nn.Parameter(torch.zeros(D, P))
        self.prenet_fc2 = nn.Parameter(torch.zeros(P, P))
        self.proj_kernel = nn.Parameter(torch.zeros(2 * H, D))
        self.proj_bias = nn.Parameter(torch.zeros(D))
        dims = [D] + [cfg.postnet_dim] * 4 + [D]
        self.postnet_convs = nn.ModuleList(
            nn.Conv1d(dims[i], dims[i + 1], 5, padding=2) for i in range(5)
        )
        self.postnet_bns = nn.ModuleList(
            nn.BatchNorm1d(cfg.postnet_dim, eps=1e-5) for _ in range(4)
        )
        # the decode kernel's merged per-layer gate weights (see
        # merge_decoder_weights); derived state, not saved
        self.register_buffer("w1m", torch.zeros(P + H, 4 * H), persistent=False)
        self.register_buffer("w2m", torch.zeros(P + 2 * H, 4 * H), persistent=False)

    @torch.no_grad()
    def merge_decoder_weights(self) -> None:
        """Build ``w1m = [w1_p; wh1]`` and ``w2m = [w2_p; w2_h1; wh2]`` from
        the LSTM parameters.  Call once after loading weights."""
        C = 2 * self.cfg.encoder_dim
        P = self.cfg.prenet_dim
        self.w1m = torch.cat([self.lstm1.w_i[C:], self.lstm1.w_h], 0).contiguous()
        self.w2m = torch.cat(
            [self.lstm2.w_i[C : C + P], self.lstm2.w_i[C + P :], self.lstm2.w_h], 0
        ).contiguous()

    def upsample(
        self,
        x: torch.Tensor,
        durations: torch.Tensor,
        n_frames: int,
        token_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Gaussian upsampling [B, T, C] tokens -> [B, n_frames, C] frames:
        frame f weighs token t by softmax_t(-(mid_t - f)^2 / sigma2);
        padding tokens (``token_mask`` false) get no weight."""
        frame_pos = torch.arange(n_frames, dtype=torch.float32, device=x.device)
        end_pos = torch.cumsum(durations, dim=1)
        mid_pos = end_pos - durations / 2.0
        d2 = torch.square(mid_pos[:, None, :] - frame_pos[None, :, None])
        logits = -d2 / self.cfg.upsample_sigma2
        if token_mask is not None:
            logits = logits.masked_fill(~token_mask[:, None, :], float("-inf"))
        return torch.softmax(logits, dim=-1) @ x

    def postnet(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.transpose(1, 2)
        for i, conv in enumerate(self.postnet_convs):
            x = conv(x)
            if i < 4:
                x = torch.tanh(self.postnet_bns[i](x))
        return x.transpose(1, 2)

    def inference(
        self,
        phonemes: torch.Tensor,
        durations: torch.Tensor,
        n_frames: int,
        lengths: Optional[torch.Tensor] = None,
        *,
        keep1: Optional[torch.Tensor] = None,
        keep2: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Autoregressive decode: [B, T] tokens + [B, T] frame durations ->
        [B, n_frames, mel_dim] log-mels (post-postnet).

        With ``cfg.prenet_dropout_at_inference`` the prenet keep-masks
        ``keep1``/``keep2`` [n_frames, B, prenet_dim] bool are used when
        given, and drawn from ``generator`` otherwise.
        """
        cfg = self.cfg
        B, T = phonemes.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long, device=phonemes.device)
        enc = self.encoder(phonemes, lengths)
        token_mask = torch.arange(T, device=phonemes.device)[None, :] < lengths[:, None]
        cond = self.upsample(enc, durations, n_frames, token_mask)  # [B, L, C]
        C, P = cond.shape[-1], cfg.prenet_dim

        g1c = cond @ self.lstm1.w_i[:C] + self.lstm1.b  # [B, L, 4H]
        g2c = cond @ self.lstm2.w_i[:C] + self.lstm2.b

        shape = (n_frames, B, P)
        if cfg.prenet_dropout_at_inference:
            keep_prob = 1.0 - cfg.prenet_dropout_rate
            if keep1 is None:
                keep1 = torch.rand(shape, generator=generator, device=cond.device) < keep_prob
            if keep2 is None:
                keep2 = torch.rand(shape, generator=generator, device=cond.device) < keep_prob
            scale = 1.0 / keep_prob
        else:
            keep1 = keep2 = torch.ones(shape, dtype=torch.bool, device=cond.device)
            scale = 1.0

        mel = ar_decode(
            g1c, g2c, keep1, keep2, self.prenet_fc1, self.prenet_fc2,
            self.w1m, self.w2m, self.proj_kernel, self.proj_bias, scale,
        )
        return mel + self.postnet(mel)
