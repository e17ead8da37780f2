"""HiFi-GAN discriminators and GAN losses (counterpart of the
discriminator and loss half of ``viettts_tpu/models/hifigan.py``).

The layout is torch's (NCW, NCHW) where the JAX package's is NWC/NHWC.
What the losses see is the same: the period reshape [B, 1, T] -> [B, 1,
T/p, p] orders samples as JAX's [B, T/p, p, 1] does, each output is
flattened in the same (time, period) order, and feature matching takes
the mean of |real - fake| over a feature map, whatever its layout.

Module and parameter names follow the JAX package's tree
(``mpd.disc_p2.conv_0.v`` is ``disc_params["mpd"]["disc_p2"]["conv_0"]["v"]``),
so ``checkpoint.gan_tree`` converts by renaming and relayout alone.  The
first scale discriminator is spectrally normalized (``SNConv``): its
power-iteration vectors ``u`` are not parameters but the ``spectral``
state, passed in and returned as a dict named like
``disc_s0.conv_0.u``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from viettts_tpu_torch.models.hifigan import WNConv
from viettts_tpu_torch.ops.mrf import LRELU_SLOPE

Spectral = Dict[str, torch.Tensor]
INIT_STD = 0.01  # flax's normal(0.01) kernel initialiser of every GAN conv


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x), min=1e-12)


class SNConv(nn.Module):
    """Spectrally normalized Conv1d: ``kernel`` (O, I/g, k) divided by
    sigma_max, estimated by one power-iteration step from ``u`` [O] (the
    JAX package's ``ConvSN1DPadded``, torch's ``spectral_norm`` in
    training).  ``u`` and ``v`` are constants in the gradient; sigma is a
    function of the kernel.  Returns the output and the new ``u``."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, groups: int, pad: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(c_out, c_in // groups, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride, self.padding, self.groups = stride, pad, groups

    def forward(self, x: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        W = self.kernel.flatten(1)  # [O, I/g * k]: a column permutation of JAX's
        Wc = W.detach()
        v = _normalize(Wc.t() @ u)
        u_new = _normalize(Wc @ v)
        sigma = u_new @ (W @ v)
        y = F.conv1d(x, self.kernel / sigma, None, self.stride, self.padding, 1, self.groups)
        return y + self.bias[:, None], u_new


class PeriodDiscriminator(nn.ModuleDict):
    """The waveform folded to [T/p, p], (k, 1) convs over it;
    ``base_channels=32`` is the upstream ladder (32, 128, 512, 1024, 1024)."""

    def __init__(self, period: int, base_channels: int = 32, kernel_size: int = 5, stride: int = 3):
        bc, k = base_channels, kernel_size
        pad = (k - 1) // 2
        chans = (1, bc, 4 * bc, 16 * bc, 32 * bc)
        layers = {
            f"conv_{i}": WNConv((o, c, k, 1), stride=(stride, 1), padding=(pad, 0))
            for i, (c, o) in enumerate(zip(chans[:-1], chans[1:]))
        }
        layers["conv_4"] = WNConv((32 * bc, 32 * bc, k, 1), stride=(1, 1), padding=(2, 0))
        layers["conv_post"] = WNConv((1, 32 * bc, 3, 1), stride=(1, 1), padding=(1, 0))
        super().__init__(layers)
        self.period = period

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        B, C, T = x.shape  # [B, 1, T]
        p = self.period
        if T % p:
            x = F.pad(x, (0, p - T % p), mode="reflect")
            T = x.shape[-1]
        x = x.view(B, C, T // p, p)
        fmap = []
        for name, layer in self.items():
            x = layer(x)
            if name != "conv_post":
                x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.ModuleDict):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), base_channels: int = 32):
        super().__init__({f"disc_p{p}": PeriodDiscriminator(p, base_channels) for p in periods})

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Waveforms [B, 1, T] -> (real outputs, fake outputs, real feature
        maps, fake feature maps), one entry a period."""
        outs = [(d(y), d(y_hat)) for d in self.values()]
        return ([r[0] for r, _ in outs], [g[0] for _, g in outs],
                [r[1] for r, _ in outs], [g[1] for _, g in outs])


# (features, kernel, stride, groups, pad) of the scale discriminator's
# convs in units of base_channels: the upstream ladder at 128
_SCALE_SPECS = ((1, 15, 1, 1, 7), (1, 41, 2, 4, 20), (2, 41, 2, 16, 20), (4, 41, 4, 16, 20),
                (8, 41, 4, 16, 20), (8, 41, 1, 16, 20), (8, 5, 1, 1, 2))


class ScaleDiscriminator(nn.ModuleDict):
    """Grouped 1D convs over the raw (or pooled) waveform, weight-normalized
    or, with ``use_spectral_norm``, spectrally normalized."""

    def __init__(self, base_channels: int = 128, use_spectral_norm: bool = False):
        bc = base_channels
        layers, c_in = {}, 1
        for i, (f, k, s, grp, pad) in enumerate(_SCALE_SPECS):
            layers[f"conv_{i}"] = self._conv(c_in, f * bc, k, s, grp, pad, use_spectral_norm)
            c_in = f * bc
        layers["conv_post"] = self._conv(c_in, 1, 3, 1, 1, 1, use_spectral_norm)
        super().__init__(layers)
        self.use_spectral_norm = use_spectral_norm

    @staticmethod
    def _conv(c_in, c_out, k, stride, groups, pad, sn):
        if sn:
            return SNConv(c_in, c_out, k, stride, groups, pad)
        return WNConv((c_out, c_in // groups, k), stride=stride, padding=pad, groups=groups)

    def forward(self, x: torch.Tensor, u: Optional[Spectral] = None):
        """[B, 1, T] -> (output [B, n], feature maps, new ``u`` by layer
        name: empty without spectral norm)."""
        fmap, u_new = [], {}
        for name, layer in self.items():
            if self.use_spectral_norm:
                x, u_new[name] = layer(x, u[name])
            else:
                x = layer(x)
            if name != "conv_post":
                x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        return x.flatten(1), fmap, u_new


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AvgPool1d(4, 2, padding 2), padding counted (the JAX package's
    ``_avg_pool_1d``)."""
    return F.avg_pool1d(x, 4, 2, 2, count_include_pad=True)


class MultiScaleDiscriminator(nn.ModuleDict):
    """Scale discriminators at x1, x2-pooled, x4-pooled... resolutions; the
    first (unpooled) is spectrally normalized."""

    def __init__(self, num_scales: int = 3, base_channels: int = 128):
        super().__init__({f"disc_s{i}": ScaleDiscriminator(base_channels, i == 0) for i in range(num_scales)})

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, spectral: Spectral, update_stats: bool = False):
        """As ``MultiPeriodDiscriminator.forward``, plus the spectral state
        after the call.  As flax applies the JAX module with
        ``mutable=["spectral"]``: with ``update_stats`` the real pass
        writes its new ``u``, the fake pass starts from that one, and only
        the real pass's is kept; without it both start from ``spectral``,
        which is returned as it was."""
        real_outs, gen_outs, real_fmaps, gen_fmaps = [], [], [], []
        new = dict(spectral)
        for i, (name, d) in enumerate(self.items()):
            if i:
                y, y_hat = avg_pool(y), avg_pool(y_hat)
            u = {k[len(name) + 1 : -2]: v for k, v in spectral.items() if k.startswith(name + ".")}
            out_r, fmap_r, u_r = d(y, u)
            if update_stats:
                u = u_r
                new.update({f"{name}.{k}.u": v for k, v in u_r.items()})
            out_g, fmap_g, _ = d(y_hat, u)
            real_outs.append(out_r)
            gen_outs.append(out_g)
            real_fmaps.append(fmap_r)
            gen_fmaps.append(fmap_g)
        return real_outs, gen_outs, real_fmaps, gen_fmaps, new


class Discriminators(nn.Module):
    """Both stacks, as the GAN trainer holds them (``disc_params`` =
    ``{"mpd": ..., "msd": ...}``)."""

    def __init__(self, periods=(2, 3, 5, 7, 11), mpd_base_channels=32, num_scales=3, msd_base_channels=128):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods, mpd_base_channels)
        self.msd = MultiScaleDiscriminator(num_scales, msd_base_channels)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor, spectral: Spectral, update_stats: bool = False):
        """-> (MPD's 4 lists, MSD's 4 lists, the new spectral state)."""
        *msd, new = self.msd(y, y_hat, spectral, update_stats)
        return self.mpd(y, y_hat), tuple(msd), new

    def spectral_names(self) -> List[str]:
        """The spectral state's names (``disc_s0.conv_0.u``, ...)."""
        return [f"{name}.{layer}.u" for name, d in self.msd.items() if d.use_spectral_norm for layer in d]

    def init_spectral(self, generator: torch.Generator) -> Spectral:
        """Cold ``u`` vectors: standard normal draws from ``generator``."""
        out = {}
        for key in self.spectral_names():
            d, layer, _ = key.split(".")
            n = self.msd[d][layer].kernel.shape[0]
            out[key] = torch.randn(n, generator=generator).to(self.msd[d][layer].kernel.device)
        return out


@torch.no_grad()
def init_gan_params(module: nn.Module, generator: torch.Generator) -> None:
    """flax's cold init of the JAX package's GAN convs, from ``generator``:
    kernels (``v``, an SN ``kernel``, a plain conv's weight) normal with
    std 0.01, biases 0, and ``g`` the per-output-channel norm of an
    independent normal(0.01) draw of ``v``'s shape (flax gives ``g`` its
    own key), not ``||v||``."""

    def normal(t):
        return torch.randn(t.shape, generator=generator).to(t.device) * INIT_STD

    for m in module.modules():
        if isinstance(m, WNConv):
            m.v.copy_(normal(m.v))
            m.g.copy_(torch.linalg.vector_norm(normal(m.v), dim=[d for d in range(m.v.dim()) if d != m.out_axis]))
        elif isinstance(m, SNConv):
            m.kernel.copy_(normal(m.kernel))
        elif isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            m.weight.copy_(normal(m.weight))
        else:
            continue
        m.bias.zero_()


# ---------------------------------------------------------------------------
# GAN losses (least squares + feature matching), reductions in float32.
# ---------------------------------------------------------------------------


def feature_matching_loss(fmaps_real, fmaps_gen) -> torch.Tensor:
    loss = 0.0
    for fmap_r, fmap_g in zip(fmaps_real, fmaps_gen):
        for r, g in zip(fmap_r, fmap_g):
            loss = loss + torch.mean(torch.abs(r.float() - g.float()))
    return loss * 2.0


def discriminator_loss(real_outs, gen_outs) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(real_outs, gen_outs):
        loss = loss + torch.mean(torch.square(1.0 - dr.float())) + torch.mean(torch.square(dg.float()))
    return loss


def generator_adversarial_loss(gen_outs) -> torch.Tensor:
    loss = 0.0
    for dg in gen_outs:
        loss = loss + torch.mean(torch.square(1.0 - dg.float()))
    return loss
