"""The int8 vocoder route at the default generator's widths: one stage of
``HifiGanConfig()`` (C = 256 and 128, ResBlock1, kernels 3 / 7 / 11,
dilations 1 / 3 / 5) through the port's ``fused_mrf`` (the twin on the
CPU) and through JAX's ``fused_mrf(quantize_int8=True, interpret=True)``,
bf16 storage, dynamic scales, on the same seeded input.

At these widths the dynamic int8 codes turn a float32 rounding into a
code flip, which the following convs spread: two float32 results that
differ by an ulp can move a stage by 1e-3 rel-RMS.  Two such differences
between the two sides are known, and each case holds the port twice:

* the ConvTranspose prologue: the port sums it in float64 (rounded once),
  JAX's kernel in float32 in its packing's order.  The prologue's input,
  weights and bias are drawn on a dyadic grid, so every one of its sums is
  exact in float32 on both sides;
* the dequantization: the port rounds ``dot * scale`` and then the bias
  add (as its CUDA kernel does, ``__fmul_rn`` / ``__fadd_rn``), while XLA's
  CPU backend fuses JAX's ``y * m + b`` (``viettts_tpu/ops/mrf.py:346-356``)
  into one rounding.

The port as it is must be within the int8 bar of ``tests/test_torch_int8.py``
(rel-RMS 5e-3, max abs 0.02 of max(|ref|, 1)); with its dequantization
rounded once, as XLA's is, within 1e-4 rel-RMS of JAX's stage.
"""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

import jax.numpy as jnp

import viettts_tpu.ops.mrf as jax_mrf
from viettts_tpu_torch.ops import mrf
from tests.test_torch_int8 import _assert_int8_close, _rel_rms
from tests.test_torch_mrf import _to

KERNEL_SIZES, DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3

CASES = {
    # name: (L_in, C_in, C, (k_up, u) or None); B=1
    "c256_prologue_x8": (32, 512, 256, (16, 8)),  # stage 0: 32 frames of conv_pre's 512 channels
    "c256": (256, 256, 256, None),
    "c128_prologue_x2": (128, 256, 128, (4, 2)),  # stage 2
}


def _case(seed, L_in, C_in, C, upsample):
    """He-like MRF weights (std sqrt(2 / fan_in)), biases 0.05.  With a
    prologue its input is k/8 for k in 0..8 and its weights and bias are
    multiples of 2**-9: each sum (at most 1,024 products of 2**-12 steps,
    below 2**6) is exact in float32, whatever the order."""
    rng = np.random.RandomState(seed)

    def he(*shape, fan_in):
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    def bias(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    weights = [(he(len(d), k, C, C, fan_in=k * C), bias(len(d), C), he(len(d), k, C, C, fan_in=k * C), bias(len(d), C))
               for k, d in zip(KERNEL_SIZES, DILATIONS)]
    if upsample is None:
        return rng.randn(1, L_in, C_in).astype(np.float32), weights, None
    k_u, u = upsample

    def grid(v):
        return (np.round(v * 512) / 512).astype(np.float32)

    x = (rng.randint(0, 9, size=(1, L_in, C_in)) / 8.0).astype(np.float32)
    w_t = grid(rng.randn(k_u, C_in, C) * np.sqrt(2.0 / (k_u * C_in / u)))
    return x, weights, (w_t, grid(rng.randn(C) * 0.05), u)


def _conv_int8_rounded_once(x, codes, scales, b, d, act, same=True):
    """``ops.mrf._conv_int8`` with dynamic scales, the dequantization and
    the bias add rounded once to float32 (an exact float64 product, then
    the sum), as XLA's CPU backend compiles JAX's kernel."""
    assert act is None and same
    c127 = torch.tensor(127.0)
    a = x.abs().amax(dim=(1, 2))
    q = torch.round(x * (c127 / torch.clamp_min(a, 1e-30))[:, None, None])
    mult = ((a * (1.0 / 127.0))[:, None] * scales[None, :])[..., None]
    k = codes.shape[0]
    dot = F.conv1d(q.double(), codes.double().permute(2, 1, 0), padding=d * (k - 1) // 2, dilation=d).float()
    return (dot.double() * mult.double() + b.double()[None, :, None]).float()


@pytest.mark.parametrize("name", list(CASES))
def test_default_width_stage_matches_pallas(name, monkeypatch):
    L_in, C_in, C, upsample = CASES[name]
    x, weights, ups = _case(11, L_in, C_in, C, upsample)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    geometry = mrf.jax_tile_geometry(L_in, C_in, C, KERNEL_SIZES, DILATIONS, False, upsample=upsample,
                                     store=torch.bfloat16, quantize_int8=True)
    assert geometry.error is None  # JAX's kernel takes the stage (no fallback)
    want = np.asarray(
        jax_mrf.fused_mrf(
            jnp.asarray(x).astype(jnp.bfloat16), _to(weights, jnp.asarray), KERNEL_SIZES, DILATIONS,
            upsample=_to(ups, jnp.asarray), compute_dtype=jnp.bfloat16, interpret=True, quantize_int8=True,
        ).astype(jnp.float32)
    )
    tw, tu, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy), _to(ups, torch.from_numpy), None,
                                        torch.bfloat16, quantize_int8=True)

    def port():
        return mrf.fused_mrf(xb, tw, KERNEL_SIZES, DILATIONS, upsample=tu, compute_dtype=torch.bfloat16,
                             quantize_int8=True).float().numpy()

    got = port()
    assert got.shape == (1, L_in * (upsample[1] if upsample else 1), C)
    _assert_int8_close(got, want)
    # the oracle's dequantization is the port's but for the one rounding
    h = torch.from_numpy(np.random.RandomState(3).randn(1, C, 64).astype(np.float32))
    w = tw[0][0]
    same = mrf._conv_int8(h, w.codes[0], w.scales[0], tw[0][1][0], 1, None)
    once = _conv_int8_rounded_once(h, w.codes[0], w.scales[0], tw[0][1][0], 1, None)
    assert 0 < (same != once).float().mean() < 0.5 and (same - once).abs().max() <= 1e-6 * same.abs().max()
    monkeypatch.setattr(mrf, "_conv_int8", _conv_int8_rounded_once)
    fused = port()
    print(f"{name}: rel-RMS {_rel_rms(got, want):.2e} against JAX, {_rel_rms(fused, want):.2e} with the "
          "dequantization rounded once")
    assert _rel_rms(fused, want) <= 1e-4


def _random_case(seed, L_in, C_in, C, upsample):
    """He-like random data throughout, the prologue too (no grid): input,
    MRF weights, then the prologue's weights and bias."""
    rng = np.random.RandomState(seed)

    def he(*shape, fan_in):
        return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    x = rng.randn(1, L_in, C_in).astype(np.float32)
    weights = [(he(len(d), k, C, C, fan_in=k * C), (rng.randn(len(d), C) * 0.05).astype(np.float32),
                he(len(d), k, C, C, fan_in=k * C), (rng.randn(len(d), C) * 0.05).astype(np.float32))
               for k, d in zip(KERNEL_SIZES, DILATIONS)]
    ups = None
    if upsample is not None:
        k_u, u = upsample
        ups = (he(k_u, C_in, C, fan_in=k_u * C_in / u), (rng.randn(C) * 0.05).astype(np.float32), u)
    return x, weights, ups


def survey(seeds=range(5)):
    """Each case on random data (``_random_case``) for each seed: the
    port's stage against JAX's, as it is and with its dequantization
    rounded once; what the dyadic prologue and the oracle take out."""
    for seed in seeds:
        for name, (L_in, C_in, C, upsample) in CASES.items():
            x, weights, ups = _random_case(seed, L_in, C_in, C, upsample)
            want = np.asarray(jax_mrf.fused_mrf(
                jnp.asarray(x).astype(jnp.bfloat16), _to(weights, jnp.asarray), KERNEL_SIZES, DILATIONS,
                upsample=_to(ups, jnp.asarray), compute_dtype=jnp.bfloat16, interpret=True, quantize_int8=True,
            ).astype(jnp.float32))
            tw, tu, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy), _to(ups, torch.from_numpy), None,
                                                torch.bfloat16, quantize_int8=True)
            rel = []
            for conv in (mrf._conv_int8, _conv_int8_rounded_once):
                with pytest.MonkeyPatch.context() as m:
                    m.setattr(mrf, "_conv_int8", conv)
                    got = mrf.fused_mrf(torch.from_numpy(x).to(torch.bfloat16), tw, KERNEL_SIZES, DILATIONS,
                                        upsample=tu, compute_dtype=torch.bfloat16, quantize_int8=True)
                rel.append(_rel_rms(got.float().numpy(), want))
            print(f"seed {seed} {name}: rel-RMS {rel[0]:.2e} against JAX, {rel[1]:.2e} with the dequantization "
                  "rounded once", flush=True)


def sensitivity(seed=0, moved=20):
    """JAX's own C = 256 stage with its x8 prologue (``_random_case``): its
    int8 and its bf16 output when ``moved`` of the input's 16,384 bf16
    values move by one ulp, against its output on the unmoved input."""
    L_in, C_in, C, upsample = CASES["c256_prologue_x8"]
    x, weights, ups = _random_case(seed, L_in, C_in, C, upsample)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    flat = xb.reshape(-1).copy()
    idx = np.random.RandomState(seed).choice(flat.size, moved, replace=False)
    flat[idx] = np.asarray(jnp.nextafter(jnp.asarray(flat[idx]).astype(jnp.bfloat16),
                                         jnp.asarray(np.inf, jnp.bfloat16)).astype(jnp.float32))
    for int8 in (True, False):
        out = [np.asarray(jax_mrf.fused_mrf(
            jnp.asarray(v.reshape(x.shape)).astype(jnp.bfloat16), _to(weights, jnp.asarray), KERNEL_SIZES, DILATIONS,
            upsample=_to(ups, jnp.asarray), compute_dtype=jnp.bfloat16, interpret=True, quantize_int8=int8,
        ).astype(jnp.float32)) for v in (xb, flat)]
        print(f"{moved} of {flat.size} inputs one bf16 ulp up: JAX's {'int8' if int8 else 'bf16'} stage moves "
              f"{_rel_rms(out[1], out[0]):.2e} rel-RMS", flush=True)


if __name__ == "__main__":
    # python -m tests.test_torch_int8_widths: the seed survey on random data
    # and JAX's own sensitivity to one-ulp moves of its input
    import jax

    jax.config.update("jax_platforms", "cpu")
    survey()
    sensitivity()
