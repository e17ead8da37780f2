"""Tacotron-2-style acoustic model (counterpart of
``viettts_tpu/models/acoustic.py``): aligned phonemes -> 80-bin log-mel.

TokenEncoder -> duration-driven Gaussian upsampling -> both decoder LSTM
layers' input gates precomputed for all frames -> the decoder -> mel
projection -> postnet residual.

* ``forward`` is the teacher-forced training forward: the decoder is an
  eager loop over frames under autograd, fed the ground-truth frames
  shifted by one.  In training, zoneout keeps the previous h and c where
  a Bernoulli(``zoneout_rate``) mask is set, while each step outputs the
  raw ``[h1, h2]``, and layer 2 takes the raw h1; dropout follows every
  encoder conv and all five postnet convs.  Prenet dropout runs twice,
  in training and, with ``prenet_dropout_at_inference``, in validation.
* ``inference`` is the autoregressive decode (kernel K1,
  ``ops/ar_decoder.py``).  Prenet dropout stays on by default, as in the
  reference; its keep-masks come from the caller or from a
  ``torch.Generator``.

Every random draw comes from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.config import AcousticModelConfig
from viettts_tpu_torch.models.encoder import TokenEncoder
from viettts_tpu_torch.models.layers import (
    BatchNorm,
    conv1d,
    dropout,
    init_batch_norm_,
    init_conv_,
    mm,
    truncated_normal_,
)
from viettts_tpu_torch.ops.ar_decoder import ar_decode
from viettts_tpu_torch.ops.rnn import LSTM, apply_gates
from viettts_tpu_torch.parallel.mesh import rand_rows
from viettts_tpu_torch.types import AcousticBatch


class AcousticModel(nn.Module):
    def __init__(self, cfg: AcousticModelConfig):
        super().__init__()
        self.cfg = cfg
        C, P, H, D = 2 * cfg.encoder_dim, cfg.prenet_dim, cfg.decoder_dim, cfg.mel_dim
        self.encoder = TokenEncoder(cfg.vocab_size, cfg.encoder_dim, cfg.encoder_dropout_rate)
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
        self.postnet_bns = nn.ModuleList(BatchNorm(cfg.postnet_dim) for _ in range(4))
        # the decode kernel's merged per-layer gate weights (see
        # merge_decoder_weights); derived state, not saved
        self.register_buffer("w1m", torch.zeros(P + H, 4 * H), persistent=False)
        self.register_buffer("w2m", torch.zeros(P + 2 * H, 4 * H), persistent=False)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The JAX model's initialisers: the encoder's (flax), the decoder
        LSTMs', truncated-normal dense kernels at +-2 sigma with sigma =
        1/sqrt(fan_in) and zero bias (haiku's ``hk.Linear``), lecun-normal
        postnet convs, unit BatchNorm."""
        self.encoder.init_params(generator)
        self.lstm1.init_params(generator)
        self.lstm2.init_params(generator)
        for w in (self.prenet_fc1, self.prenet_fc2, self.proj_kernel):
            truncated_normal_(w, w.shape[0] ** -0.5, generator)
        self.proj_bias.zero_()
        for conv in self.postnet_convs:
            init_conv_(conv, generator)
        for bn in self.postnet_bns:
            init_batch_norm_(bn)
        self.merge_decoder_weights()

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
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gaussian upsampling [B, T, C] tokens -> [B, n_frames, C] frames:
        frame f weighs token t by softmax_t(-(mid_t - f)^2 / sigma2);
        padding tokens (``token_mask`` false) get no weight.  Returns the
        frames and the weights [B, n_frames, T] (the attention plot of
        the validation snapshot)."""
        frame_pos = torch.arange(n_frames, dtype=torch.float32, device=x.device)
        end_pos = torch.cumsum(durations, dim=1)
        mid_pos = end_pos - durations / 2.0
        d2 = torch.square(mid_pos[:, None, :] - frame_pos[None, :, None])
        logits = -d2 / self.cfg.upsample_sigma2
        if token_mask is not None:
            logits = logits.masked_fill(~token_mask[:, None, :], float("-inf"))
        w = torch.softmax(logits, dim=-1)
        return mm(w, x), w

    def postnet(
        self, mel: torch.Tensor, *, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        x = mel.transpose(1, 2)
        for i, conv in enumerate(self.postnet_convs):
            x = conv1d(conv, x)
            if i < 4:
                x = torch.tanh(self.postnet_bns[i](x, train=train))
            if train:  # after every conv, the last included
                x = dropout(x, self.cfg.postnet_dropout_rate, generator)
        return x.transpose(1, 2)

    def _prenet(
        self, x: torch.Tensor, deterministic: bool, generator: Optional[torch.Generator]
    ) -> torch.Tensor:
        """The prenet on teacher-forced frames [.., mel_dim]."""
        rate = self.cfg.prenet_dropout_rate
        x = F.relu(mm(x, self.prenet_fc1))
        if not deterministic:
            x = dropout(x, rate, generator)
        x = F.relu(mm(x, self.prenet_fc2))
        if not deterministic:
            x = dropout(x, rate, generator)
        return x

    def forward(
        self, batch: AcousticBatch, *, train: bool, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Teacher-forced forward.  ``batch.mels`` are the decoder inputs
        (go frame + ground truth shifted by one), ``batch.durations`` in
        frames.  Returns (mel before the postnet, mel after it, the
        upsampling weights of batch row 0 [n_frames, T])."""
        cfg = self.cfg
        enc = self.encoder(batch.phonemes, batch.lengths, train=train, generator=generator)
        n_frames = batch.mels.shape[1]
        cond, attn = self.upsample(enc, batch.durations, n_frames)  # [B, L, C]
        pre = self._prenet(batch.mels, not train and not cfg.prenet_dropout_at_inference, generator)
        x = torch.cat([cond, pre], dim=-1)  # [B, L, C + P], in the promoted dtype
        B, L, cx = x.shape
        H = cfg.decoder_dim

        # both layers' input gates for every frame, as two matmuls
        g1 = mm(x, self.lstm1.w_i) + self.lstm1.b  # [B, L, 4H]
        g2x = mm(x, self.lstm2.w_i[:cx]) + self.lstm2.b
        w_h1, w2_h1, w_h2 = (w.to(x.dtype) for w in (self.lstm1.w_h, self.lstm2.w_i[cx:], self.lstm2.w_h))
        zoneout = train and cfg.zoneout_rate > 0
        if zoneout:  # keep-previous masks for (h1, c1, h2, c2)
            zmask = [
                rand_rows((L, B, H), generator, x.device, batch_axis=1) < cfg.zoneout_rate
                for _ in range(4)
            ]
        h1 = c1 = h2 = c2 = x.new_zeros(B, H)
        h1s, h2s = [], []
        # frames by unbind, not by indexing: the backward of L selects
        # would zero-fill and sum L full-size gradients of g1 and g2x
        g1, g2x = g1.unbind(1), g2x.unbind(1)
        for t in range(L):
            n_h1, n_c1 = apply_gates(torch.addmm(g1[t], h1, w_h1), c1)
            n_h2, n_c2 = apply_gates(torch.addmm(g2x[t], n_h1, w2_h1) + h2 @ w_h2, c2)
            # the step outputs the raw activations; zoneout acts on the state
            h1s.append(n_h1)
            h2s.append(n_h2)
            if zoneout:
                h1 = torch.where(zmask[0][t], h1, n_h1)
                c1 = torch.where(zmask[1][t], c1, n_c1)
                h2 = torch.where(zmask[2][t], h2, n_h2)
                c2 = torch.where(zmask[3][t], c2, n_c2)
            else:
                h1, c1, h2, c2 = n_h1, n_c1, n_h2, n_c2
        hs = torch.cat([torch.stack(h1s, 1), torch.stack(h2s, 1)], dim=-1)  # [B, L, 2H]
        mel = mm(hs, self.proj_kernel) + self.proj_bias
        return mel, mel + self.postnet(mel, train=train, generator=generator), attn[0]

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
        cond, _ = self.upsample(enc, durations, n_frames, token_mask)  # [B, L, C]
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
