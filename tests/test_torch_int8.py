"""The int8 vocoder route of the port (kernel K3's plain twin, calibration,
the clip probe, the generator) against the JAX package, on the CPU.

The JAX side runs ``fused_mrf(quantize_int8=True)`` in interpret mode.  Its
dynamic activation scale is one amax per tile window; every size here fits
one tile, where that is one amax a batch row.  Inputs that span several
tiles, and the stages whose tile geometry JAX refuses, are in
``tests/test_torch_int8_tiles.py``.

Bars: the twin and the int8 generator against JAX, rel-RMS 5e-3 and max
abs 0.02 of max(|ref|, 1) (both sides quantize alike; an int8 code can
flip where float32 sums round differently); calibration scales and clip
fractions 1e-5 relative; each int8 route against its own float32 route
within JAX's bars, rel-RMS 0.03 for a stage (tests/test_mrf.py:402) and
0.05 for the generator (:431).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import viettts_tpu.ops.mrf as jax_mrf
from viettts_tpu.models.hifigan import (
    generator_apply_fused as jax_apply_fused,
    generator_calibrate_int8 as jax_calibrate,
    generator_int8_clip_stats as jax_clip_stats,
)
from viettts_tpu_torch.models import hifigan
from viettts_tpu_torch.ops import mrf
from tests.test_torch_models import _generator, _hifigan_cfg
from tests.test_torch_mrf import DILATIONS, KERNEL_SIZES, _case, _to


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _assert_int8_close(got, want):
    assert got.shape == want.shape
    assert _rel_rms(got, want) <= 5e-3
    assert np.abs(got - want).max() <= 0.02 * max(float(np.abs(want).max()), 1.0)


def _stage_amax(x, weights, upsample):
    """Per-conv input amaxes of one stage in float32 (the static scales)."""
    _, vals = mrf.mrf_walk(
        torch.from_numpy(x).transpose(1, 2), _to(weights, torch.from_numpy), KERNEL_SIZES,
        DILATIONS, lambda j, y: y.abs().amax(), upsample=_to(upsample, torch.from_numpy),
    )
    return torch.stack(vals)


CASES = {
    # name: (B, L_in, C_in, C, (k_up, u) or None, post, resblock2, dtype)
    "mrf_f32": (2, 256, 16, 16, None, False, False, "float32"),
    "resblock2_bf16": (2, 256, 16, 16, None, False, True, "bfloat16"),
    "prologue_16_8_bf16": (2, 32, 32, 16, (16, 8), False, False, "bfloat16"),
    "epilogue_f32": (1, 128, 16, 8, (4, 2), True, False, "float32"),
    "prologue_epilogue_bf16": (2, 32, 32, 16, (16, 8), True, False, "bfloat16"),
}


@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("name", list(CASES))
def test_int8_twin_matches_pallas_interpret(name, scales):
    B, L_in, C_in, C, upsample, post, resblock2, dtype = CASES[name]
    x, weights, ups, pst = _case(7, B, L_in, C_in, C, upsample, post, resblock2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    act = _stage_amax(x, weights, ups) if scales == "static" else None

    want = np.asarray(
        jax_mrf.fused_mrf(
            jnp.asarray(x).astype(jdt), _to(weights, jnp.asarray), KERNEL_SIZES, DILATIONS,
            upsample=_to(ups, jnp.asarray), post=_to(pst, jnp.asarray), compute_dtype=jdt,
            interpret=True, quantize_int8=True,
            act_scales=None if act is None else jnp.asarray(act.numpy()),
        ).astype(jnp.float32)
    )
    tw, tu, tp = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), _to(pst, torch.from_numpy),
        tdt, quantize_int8=True,
    )
    got = mrf.fused_mrf(
        torch.from_numpy(x).to(tdt), tw, KERNEL_SIZES, DILATIONS, upsample=tu, post=tp,
        compute_dtype=tdt, quantize_int8=True, act_scales=act,
    )
    L = L_in * (upsample[1] if upsample else 1)
    assert tuple(got.shape) == (B, L, 1 if post else C)
    assert got.dtype == (torch.float32 if post else tdt)
    _assert_int8_close(got.float().numpy(), want)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_int8_stage_close_to_float32(scales):
    x, weights, ups, pst = _case(9, 2, 256, 16, 16, None, False, False)
    act = _stage_amax(x, weights, None) if scales == "static" else None
    w32, _, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy))
    w8, _, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy), quantize_int8=True)
    ref = mrf.fused_mrf(torch.from_numpy(x), w32, KERNEL_SIZES, DILATIONS).numpy()
    got = mrf.fused_mrf(
        torch.from_numpy(x), w8, KERNEL_SIZES, DILATIONS, quantize_int8=True, act_scales=act
    ).numpy()
    assert 0 < _rel_rms(got, ref) < 0.03


def test_weight_quantizer_matches_jax_packing():
    """Per-output-channel scales and half-even codes, as the TPU kernel's
    packed-column quantizer (``mrf.py:576-580``) computes them."""
    rng = np.random.RandomState(5)
    w = (rng.randn(3, 7, 16, 16) * 0.1).astype(np.float32)
    q = mrf.quantize_weight_int8(torch.from_numpy(w))
    for j in range(3):
        s = np.asarray(jnp.maximum(jnp.max(jnp.abs(w[j]), axis=(0, 1)), 1e-12) / 127.0)
        codes = np.asarray(jnp.clip(jnp.round(w[j] / s), -127.0, 127.0).astype(jnp.int8))
        np.testing.assert_array_equal(q.scales[j].numpy(), s)
        np.testing.assert_array_equal(q.codes[j].numpy(), codes)
    assert q.codes.dtype == torch.int8 and int(q.codes.abs().max()) == 127


def test_int8_weights_are_quantized_from_float32():
    """The bf16 int8 route quantizes the float32 weights, not their bf16
    copies (JAX packs in float32, ``mrf.py:87``)."""
    cfg = _hifigan_cfg()
    _, _, port, _ = _generator(cfg, seed=6)
    weights, upsample, _ = port.fused_weights(torch.bfloat16, quantize_int8=True)[0]
    w1 = torch.stack([c.weight.permute(2, 1, 0) for c in port.resblocks[0].convs1])
    want = mrf.quantize_weight_int8(w1)
    torch.testing.assert_close(weights[0][0].codes, want.codes, rtol=0, atol=0)
    torch.testing.assert_close(weights[0][0].scales, want.scales, rtol=0, atol=0)
    assert isinstance(upsample[0], mrf.F64Conv)
    assert upsample[0].w.dtype == torch.bfloat16  # the prologue keeps bf16 storage


def test_cpu_int8_takes_the_plain_twin():
    x, weights, ups, pst = _case(3, 1, 16, 8, 4, (4, 2), True)
    tw, tu, tp = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), _to(pst, torch.from_numpy),
        quantize_int8=True,
    )
    counts = (mrf.fused_mrf.launches, mrf.fused_mrf.int8_launches, mrf.fused_mrf.plain_calls)
    mrf.fused_mrf(torch.from_numpy(x), tw, KERNEL_SIZES, DILATIONS, upsample=tu, post=tp, quantize_int8=True)
    assert (mrf.fused_mrf.launches, mrf.fused_mrf.int8_launches, mrf.fused_mrf.plain_calls) == (
        counts[0], counts[1], counts[2] + 1,
    )


def test_wrapper_rejects_mismatched_int8_arguments():
    x, weights, _, _ = _case(4, 1, 32, 8, 8, None, False)
    w8, _, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy), quantize_int8=True)
    w32, _, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy))
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="must be an Int8Conv"):
        mrf.fused_mrf(xt, w32, KERNEL_SIZES, DILATIONS, quantize_int8=True)
    with pytest.raises(ValueError, match="must not be an Int8Conv"):
        mrf.fused_mrf(xt, w8, KERNEL_SIZES, DILATIONS)
    with pytest.raises(ValueError, match="act_scales"):
        mrf.fused_mrf(xt, w8, KERNEL_SIZES, DILATIONS, quantize_int8=True, act_scales=torch.ones(3))
    with pytest.raises(ValueError, match="needs quantize_int8"):
        mrf.fused_mrf(xt, w32, KERNEL_SIZES, DILATIONS, act_scales=torch.ones(mrf.n_convs(w32)))
    with pytest.raises(ValueError, match="quantize from float32"):
        mrf.quantize_weight_int8(torch.ones(3, 4, 4, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_weights_carry_the_kernel_layouts(dtype):
    """``prepare_mrf_weights(quantize_int8=True)``: W1/W2 also carry their
    codes K-major, [D, k, C_out, C_in], for the kernel's int8 dots, and the
    upsample weight its float64 copy [k, C_out, C_in] for the FP64 prologue,
    exactly the stored values (float32: the float32 weights themselves)."""
    _, weights, ups, _ = _case(12, 1, 8, 24, 12, (16, 8), False)
    tw, tu, _ = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), None, dtype, quantize_int8=True,
    )
    for blk in tw:
        for w in (blk[0], blk[2]):
            assert w.kmajor.dtype == torch.int8 and w.kmajor.is_contiguous()
            assert w.kmajor.shape == w.codes.shape[:2] + (12, 12)
            assert torch.equal(w.kmajor, w.codes.transpose(-1, -2))
    w_t = tu[0]
    assert isinstance(w_t, mrf.F64Conv) and w_t.w.dtype == dtype
    assert w_t.kmajor.dtype == torch.float64 and w_t.kmajor.is_contiguous()
    assert w_t.kmajor.shape == (16, 12, 24)
    assert torch.equal(w_t.kmajor.transpose(-1, -2), w_t.w.double())
    if dtype == torch.float32:
        assert torch.equal(w_t.kmajor.transpose(-1, -2).float(), torch.from_numpy(ups[0]))


def _on(tree, device):
    """A prepared weight tree (tuples, NamedTuples, tensors) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_on(t, device) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on(t, device) for t in tree)
    return tree


@pytest.mark.parametrize("fault", [None, "no_kmajor", "kmajor_shape", "kmajor_dtype", "no_f64", "f64_shape"])
def test_wrapper_checks_the_kernel_layouts(fault):
    """A mis-shaped or mistyped kernel layout is refused everywhere; a
    missing one only where a kernel would run (any device but the CPU:
    ``meta`` stands in for the card here, and with every layout in place it
    gets as far as "no kernel for device")."""
    x, weights, ups, _ = _case(13, 1, 8, 24, 12, (16, 8), False)
    tw, tu, _ = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), quantize_int8=True,
    )
    w1 = tw[0][0]
    if fault == "no_kmajor":
        w1 = w1._replace(kmajor=None)
    elif fault == "kmajor_shape":
        w1 = w1._replace(kmajor=w1.kmajor[:, :1].contiguous())
    elif fault == "kmajor_dtype":
        w1 = w1._replace(kmajor=w1.kmajor.float())
    tw = [(w1,) + tuple(tw[0][1:])] + list(tw[1:])
    if fault == "no_f64":
        tu = (tu[0].w,) + tuple(tu[1:])
    elif fault == "f64_shape":
        tu = (tu[0]._replace(kmajor=tu[0].kmajor.transpose(-1, -2).contiguous()),) + tuple(tu[1:])
    xt = torch.from_numpy(x)
    refused = {"no_kmajor": "no K-major codes", "kmajor_shape": "K-major codes", "kmajor_dtype": "kmajor is torch.float32",
               "no_f64": "must be F64Conv", "f64_shape": "float64 K-major weight"}.get(fault)
    if fault in ("no_kmajor", "no_f64", None):
        # the twin needs no kernel layout
        mrf.fused_mrf(xt, tw, KERNEL_SIZES, DILATIONS, upsample=tu, quantize_int8=True)
        with pytest.raises(ValueError, match=refused or "no kernel for device meta"):
            mrf.fused_mrf(_on(xt, "meta"), _on(tw, "meta"), KERNEL_SIZES, DILATIONS,
                          upsample=_on(tu, "meta"), quantize_int8=True)
    else:
        with pytest.raises(ValueError, match=refused):
            mrf.fused_mrf(xt, tw, KERNEL_SIZES, DILATIONS, upsample=tu, quantize_int8=True)


# 16 mel frames: the smallest length at which JAX runs every stage of this
# config through the quantized fused kernel (shorter mels fail its tile
# alignment and stage 0 falls back to plain, unquantized XLA convs).
FRAMES = 16


@pytest.fixture(scope="module", params=["1", "2"])
def generator(request):
    cfg = _hifigan_cfg(request.param)
    gen, variables, port, mel = _generator(cfg, seed=8, T=FRAMES)
    return cfg, variables["params"], port, mel


def test_calibration_and_clip_stats_match_jax(generator):
    cfg, params, port, mel = generator
    want = jax_calibrate(cfg, params, jnp.asarray(mel), margin=1.25)
    got = hifigan.generator_calibrate_int8(port, torch.from_numpy(mel), margin=1.25)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    n_convs = 5 if cfg.resblock == "2" else 10  # dilation units (3 + 2) x convs per unit
    for i in want:
        assert got[i].shape == (n_convs,)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5)
    # probe with thresholds among the top tenth of each conv input's
    # magnitudes, in the middle of the widest gap between two of them: many
    # inputs clip, and none lies within float32 rounding of its threshold
    def gap_threshold(i, j, y):
        top = y.abs().flatten().sort().values[-max(y.numel() // 10, 2):]
        k = torch.argmax(top[1:] - top[:-1])
        return (top[k] + top[k + 1]) / 2

    tight = hifigan._mrf_activation_walk(port, torch.from_numpy(mel), gap_threshold)
    want_clip = jax_clip_stats(cfg, params, jnp.asarray(mel), {i: jnp.asarray(v.numpy()) for i, v in tight.items()})
    got_clip = hifigan.generator_int8_clip_stats(port, torch.from_numpy(mel), tight)
    for i in want_clip:
        np.testing.assert_allclose(got_clip[i].numpy(), np.asarray(want_clip[i]), rtol=1e-5, atol=1e-7)
    assert max(float(v.max()) for v in got_clip.values()) > 0


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_generator_int8_matches_jax(generator, scales, monkeypatch):
    cfg, params, port, mel = generator
    calls = []
    jax_fused = jax_mrf.fused_mrf

    def counted(*args, **kwargs):
        out = jax_fused(*args, **kwargs)  # raises before counting if JAX falls back
        calls.append(kwargs["quantize_int8"])
        return out

    monkeypatch.setattr(jax_mrf, "fused_mrf", counted)
    act = hifigan.generator_calibrate_int8(port, torch.from_numpy(mel)) if scales == "static" else None
    want = np.asarray(
        jax_apply_fused(
            cfg, params, jnp.asarray(mel), compute_dtype=jnp.bfloat16, interpret=True,
            quantize_int8=True,
            act_scales=None if act is None else {i: jnp.asarray(v.numpy()) for i, v in act.items()},
        )
    )
    assert calls == [True] * 4  # every stage quantized, none on the plain fallback
    with torch.no_grad():
        got = hifigan.generator_apply_fused(
            port, torch.from_numpy(mel), torch.bfloat16, quantize_int8=True, act_scales=act
        ).numpy()
        f32 = hifigan.generator_apply_fused(port, torch.from_numpy(mel)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, FRAMES * 256, 1)
    _assert_int8_close(got, want)
    assert 0 < _rel_rms(got, f32) < 0.05
