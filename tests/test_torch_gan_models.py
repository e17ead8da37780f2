"""The port's GAN models against the JAX package's, on the CPU, at tiny
widths (generator 16 channels, one ResBlock1 (3, (1, 3)); MPD periods
(2, 3) at base 4; MSD 2 scales at base 16; B=4).

Both sides get the same seeded numpy values (shapes from
``jax.eval_shape``), loaded into the port through
``checkpoint.named_from_gan_tree``:

* the weight-normalized generator, float32 within 1e-5 and bfloat16
  within 2e-2 of the output's scale;
* MPD and MSD outputs and every feature map within 1e-5 (the port is
  NCW/NCHW, JAX NWC/NHWC), on a length that makes both periods pad;
* the MSD's spectral-norm step with and without ``update_stats`` (the
  fake pass starts from the real pass's new ``u``) and the returned ``u``
  within 1e-5;
* the three GAN losses; the tree bridge both ways; a folded port
  generator served by ``load_generator``; the cold init's distribution.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viettts_tpu.config import HifiGanConfig
from viettts_tpu.models import hifigan as jax_hifigan
from viettts_tpu_torch import checkpoint as ckpt
from viettts_tpu_torch.models import discriminators as port_disc
from viettts_tpu_torch.models.hifigan import Generator as PortGenerator

from test_torch_pipeline import port_config

B, FRAMES, LENGTH = 4, 2, 515  # 515 = 2 * 257 + 1 = 3 * 171 + 2: both periods pad
HCFG = HifiGanConfig(
    upsample_initial_channel=16, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
    segment_size=512, mpd_periods=(2, 3), mpd_base_channels=4, msd_scales=2, msd_base_channels=16,
)


def seed_gan_tree(tree, rng):
    """Seeded values for a tree of GAN shapes: ``v`` and kernels at
    1/sqrt(fan_in), ``g`` near 1 (each output channel's weight has norm
    g), small biases, standard normal spectral ``u``."""

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        noise = rng.randn(*shape).astype(np.float32)
        if name == "g":
            return (0.8 + 0.2 * np.abs(noise)).astype(np.float32)
        if name == "u":
            return noise
        if len(shape) >= 2:
            return noise / np.float32(np.sqrt(np.prod(shape[:-1])))
        return 0.05 * noise

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_gan_variables(h, seed=0, frames=FRAMES, length=LENGTH):
    """(generator params, disc params {"mpd", "msd"}, spectral) of the
    JAX modules at ``h``, seeded."""
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(0)
    gen = jax_hifigan.Generator(h, use_wn=True)
    mpd = jax_hifigan.MultiPeriodDiscriminator(periods=h.mpd_periods, base_channels=h.mpd_base_channels)
    msd = jax_hifigan.MultiScaleDiscriminator(num_scales=h.msd_scales, base_channels=h.msd_base_channels)
    y = jnp.zeros((1, length, 1))
    g_shapes = jax.eval_shape(lambda: gen.init(key, jnp.zeros((1, frames, h.mel_dim))))["params"]
    msd_shapes = jax.eval_shape(lambda: msd.init(key, y, y))
    d_shapes = {"mpd": jax.eval_shape(lambda: mpd.init(key, y, y))["params"], "msd": msd_shapes["params"]}
    return (seed_gan_tree(g_shapes, rng), seed_gan_tree(d_shapes, rng),
            seed_gan_tree(msd_shapes["spectral"], rng))


def port_models(h, gen_params, disc_params, dtype=torch.float32):
    """The port's weight-normalized generator and discriminators holding
    the JAX trees' values."""
    ph = port_config(h)
    gen = PortGenerator(ph, use_wn=True, dtype=dtype)
    discs = port_disc.Discriminators(ph.mpd_periods, ph.mpd_base_channels, ph.msd_scales, ph.msd_base_channels)
    for module, tree in ((gen, gen_params), (discs, disc_params)):
        named = dict(module.named_parameters())
        with torch.no_grad():
            for k, a in ckpt.named_from_gan_tree(tree, list(named), ph.resblock == "2").items():
                named[k].copy_(torch.from_numpy(a))
    return gen, discs


def port_spectral(discs, spectral):
    return {k: torch.from_numpy(a) for k, a in ckpt.named_from_gan_tree(spectral, discs.spectral_names()).items()}


def _waves(seed, length=LENGTH):
    rng = np.random.RandomState(seed)
    return [(0.3 * rng.randn(B, length)).astype(np.float32) for _ in range(2)]


def _as_jax_fmap(t):
    """Port NCHW / NCW -> JAX NHWC / NWC."""
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t.transpose(1, 2)).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0,
                               atol=tol * max(1.0, float(np.abs(np.asarray(want, np.float32)).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wn_generator_matches_jax(dtype):
    gen_params, disc_params, _ = jax_gan_variables(HCFG, seed=1)
    mel = np.random.RandomState(2).randn(B, FRAMES, 80).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_hifigan.Generator(HCFG, use_wn=True, dtype=jdt).apply({"params": gen_params}, jnp.asarray(mel))
    gen, _ = port_models(HCFG, gen_params, disc_params, getattr(torch, dtype))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel))
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape) == (B, FRAMES * 256, 1)
    assert float(np.abs(np.asarray(want)).max()) > 0.05
    _close(got.numpy(), want, 1e-5 if dtype == "float32" else 2e-2)


def test_mpd_outputs_and_feature_maps_match_jax():
    gen_params, disc_params, _ = jax_gan_variables(HCFG, seed=3)
    y, y_hat = _waves(4)
    mpd = jax_hifigan.MultiPeriodDiscriminator(periods=HCFG.mpd_periods, base_channels=HCFG.mpd_base_channels)
    want = mpd.apply({"params": disc_params["mpd"]}, jnp.asarray(y)[..., None], jnp.asarray(y_hat)[..., None])
    _, discs = port_models(HCFG, gen_params, disc_params)
    with torch.no_grad():
        got = discs.mpd(torch.from_numpy(y)[:, None], torch.from_numpy(y_hat)[:, None])
    for outs_g, outs_w in zip(got[:2], want[:2]):
        for g, w in zip(outs_g, outs_w):
            assert tuple(g.shape) == w.shape
            _close(g.numpy(), w, 1e-5)
    n_maps = 0
    for fmaps_g, fmaps_w in zip(got[2:], want[2:]):
        for per_g, per_w in zip(fmaps_g, fmaps_w):
            for g, w in zip(per_g, per_w):
                assert _as_jax_fmap(g).shape == w.shape
                _close(_as_jax_fmap(g), w, 1e-5)
                n_maps += 1
    assert n_maps == 2 * len(HCFG.mpd_periods) * 6


@pytest.mark.parametrize("update_stats", [False, True])
def test_msd_and_spectral_norm_step_match_jax(update_stats):
    """With ``update_stats`` flax writes the real pass's ``u`` and the fake
    pass starts from it, so on equal inputs the two outputs differ; the
    port does the same and returns that ``u``."""
    gen_params, disc_params, spectral = jax_gan_variables(HCFG, seed=5)
    y, y_hat = _waves(6)
    y_hat[:2] = y[:2]  # rows where real and fake are the same waveform
    msd = jax_hifigan.MultiScaleDiscriminator(num_scales=HCFG.msd_scales, base_channels=HCFG.msd_base_channels)
    variables = {"params": disc_params["msd"], "spectral": spectral}
    jy, jyh = jnp.asarray(y)[..., None], jnp.asarray(y_hat)[..., None]
    if update_stats:
        want, updates = msd.apply(variables, jy, jyh, update_stats=True, mutable=["spectral"])
        want_u = updates["spectral"]
    else:
        want, want_u = msd.apply(variables, jy, jyh), spectral
    _, discs = port_models(HCFG, gen_params, disc_params)
    u0 = port_spectral(discs, spectral)
    with torch.no_grad():
        *got, got_u = discs.msd(torch.from_numpy(y)[:, None], torch.from_numpy(y_hat)[:, None], u0, update_stats)
    for outs_g, outs_w in zip(got[:2], want[:2]):
        for g, w in zip(outs_g, outs_w):
            _close(g.numpy(), w, 1e-5)
    for fmaps_g, fmaps_w in zip(got[2:], want[2:]):
        for per_g, per_w in zip(fmaps_g, fmaps_w):
            for g, w in zip(per_g, per_w):
                _close(_as_jax_fmap(g), w, 1e-5)
    same_rows_gap = float(np.abs(np.asarray(want[0][0][:2]) - np.asarray(want[1][0][:2])).max())
    assert (same_rows_gap > 1e-4) == update_stats  # the trap is exercised
    want_named = ckpt.named_from_gan_tree(want_u, discs.spectral_names())
    assert sorted(got_u) == sorted(want_named) and len(got_u) == 8
    for k, w in want_named.items():
        np.testing.assert_allclose(got_u[k].numpy(), w, rtol=0, atol=1e-5, err_msg=k)
        if not update_stats:
            assert got_u[k] is u0[k]


def test_gan_losses_match_jax():
    rng = np.random.RandomState(7)
    outs_r = [rng.randn(B, n).astype(np.float32) for n in (9, 17, 5)]
    outs_g = [rng.randn(B, n).astype(np.float32) for n in (9, 17, 5)]
    fmaps_r = [[rng.randn(B, 3, n).astype(np.float32) for n in (8, 4)] for _ in range(2)]
    fmaps_g = [[rng.randn(B, 3, n).astype(np.float32) for n in (8, 4)] for _ in range(2)]

    def t(xs):
        return [torch.from_numpy(x) if isinstance(x, np.ndarray) else t(x) for x in xs]

    def j(xs):
        return [jnp.asarray(x) if isinstance(x, np.ndarray) else j(x) for x in xs]

    pairs = [
        (port_disc.discriminator_loss(t(outs_r), t(outs_g)), jax_hifigan.discriminator_loss(j(outs_r), j(outs_g))),
        (port_disc.generator_adversarial_loss(t(outs_g)), jax_hifigan.generator_adversarial_loss(j(outs_g))),
        (port_disc.feature_matching_loss(t(fmaps_r), t(fmaps_g)),
         jax_hifigan.feature_matching_loss(j(fmaps_r), j(fmaps_g))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_gan_tree_bridge_is_the_jax_tree_both_ways():
    """A port module's tensors -> the JAX trees (same structure and shapes
    as flax's) -> back, bit-exact; a ResBlock2 generator maps ``convs1``
    to JAX's ``convs_*``."""
    for h in (HCFG, dataclasses.replace(HCFG, resblock="2")):
        gen_params, disc_params, spectral = jax_gan_variables(h, seed=8)
        gen, discs = port_models(h, gen_params, disc_params)
        resblock2 = h.resblock == "2"
        for module, want in ((gen, gen_params), (discs, disc_params)):
            named = dict(module.named_parameters())
            tree = ckpt.gan_tree(named, resblock2)
            assert jax.tree.structure(tree) == jax.tree.structure(want)
            for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(want)):
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))
        sp = port_spectral(discs, spectral)
        assert jax.tree.structure(ckpt.gan_tree(sp)) == jax.tree.structure(spectral)


def test_folded_generator_serves_through_load_generator():
    """The folded params of a weight-normalized generator give a plain
    ``Generator`` (the serving one) the same waveform, and the JAX fold of
    the same tree is the port's; ``load_generator`` refuses a WN model."""
    gen_params, disc_params, _ = jax_gan_variables(HCFG, seed=9)
    wn, _ = port_models(HCFG, gen_params, disc_params)
    folded = ckpt.fold_weight_norm(ckpt.gan_tree(dict(wn.named_parameters())))
    jax_folded = jax_hifigan.fold_weight_norm(gen_params)
    for a, b in zip(jax.tree.leaves(folded), jax.tree.leaves(jax_folded)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    plain = PortGenerator(port_config(HCFG))
    ckpt.load_generator(plain, {"params": folded})
    mel = torch.from_numpy(np.random.RandomState(10).randn(B, FRAMES, 80).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(plain(mel).numpy(), wn(mel).numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="plain Generator"):
        ckpt.load_generator(wn, {"params": folded})


def test_cold_init_follows_flax():
    """``init_gan_params``: kernels normal(0.01), biases 0, and ``g`` the
    norm of an independent draw (flax gives ``g`` its own key), so it is
    near ``||v||`` in distribution but not equal to it; spectral ``u``
    standard normal."""
    ph = port_config(dataclasses.replace(HCFG, mpd_base_channels=8, msd_base_channels=32))
    gen = PortGenerator(ph, use_wn=True)
    discs = port_disc.Discriminators(ph.mpd_periods, ph.mpd_base_channels, ph.msd_scales, ph.msd_base_channels)
    rng = torch.Generator().manual_seed(0)
    port_disc.init_gan_params(gen, rng)
    port_disc.init_gan_params(discs, rng)
    u = discs.init_spectral(rng)
    big = dict(discs.named_parameters())["msd.disc_s1.conv_4.v"].detach()
    assert abs(float(big.std()) / 0.01 - 1) < 0.05
    for name, p in {**dict(gen.named_parameters()), **dict(discs.named_parameters())}.items():
        p = p.detach()
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0, name
        elif name.endswith(".g"):
            conv = dict(gen.named_modules()).get(name[:-2]) or dict(discs.named_modules())[name[:-2]]
            dims = [d for d in range(conv.v.dim()) if d != conv.out_axis]
            norm = torch.linalg.vector_norm(conv.v.detach(), dim=dims)
            assert not torch.equal(p, norm), name
            if p.numel() >= 64:
                assert abs(float(p.mean() / norm.mean()) - 1) < 0.1, name
    all_u = torch.cat(list(u.values()))
    assert len(u) == 8 and abs(float(all_u.std()) - 1) < 0.15
