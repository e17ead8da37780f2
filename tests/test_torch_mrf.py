"""Kernel K2's plain twin (``fused_mrf_plain``) against the JAX Pallas
``fused_mrf`` in interpret mode, and the CPU dispatch of the ``fused_mrf``
wrapper.

Tolerances follow tests/test_mrf.py: float32 at 2e-5 of the output scale
(same math, differently ordered sums); bf16 storage at 0.02 of the output
scale (both sides round weights and stage I/O to bf16 and compute in
float32, but the sums differ in order before the final bf16 rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viettts_tpu.ops.mrf import fused_mrf as jax_fused_mrf
from viettts_tpu_torch.ops import mrf

KERNEL_SIZES = (3, 7)
DILATIONS = ((1, 3, 5), (1, 3))


def _case(seed, B, L_in, C_in, C, upsample, post, resblock2=False):
    rng = np.random.RandomState(seed)

    def w(*shape, s=0.05):
        return (rng.randn(*shape) * s).astype(np.float32)

    x = w(B, L_in, C_in, s=1.0)
    weights = []
    for k, dils in zip(KERNEL_SIZES, DILATIONS):
        n = len(dils)
        if resblock2:
            weights.append((w(n, k, C, C, s=0.1), w(n, C), None, None))
        else:
            weights.append((w(n, k, C, C, s=0.1), w(n, C), w(n, k, C, C, s=0.1), w(n, C)))
    ups = None
    if upsample is not None:
        k_u, u = upsample
        ups = (w(k_u, C_in, C, s=0.2), w(C), u)
    pst = (w(7, C, 1, s=0.2), w(1)) if post else None
    return x, weights, ups, pst


def _to(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(t, fn) for t in tree)
    if isinstance(tree, int):
        return tree
    return fn(tree)


CASES = {
    # name: (B, L_in, C_in, C, (k_up, u) or None, post, resblock2, dtype)
    "mrf_f32": (2, 256, 16, 16, None, False, False, "float32"),
    "prologue_16_8_f32": (2, 32, 32, 16, (16, 8), False, False, "float32"),
    "prologue_4_2_f32": (1, 128, 16, 8, (4, 2), False, False, "float32"),
    "epilogue_f32": (1, 128, 16, 8, (4, 2), True, False, "float32"),
    "resblock2_f32": (2, 256, 16, 16, None, False, True, "float32"),
    "mrf_bf16": (1, 256, 16, 16, None, False, False, "bfloat16"),
    "prologue_epilogue_bf16": (2, 32, 32, 16, (16, 8), True, False, "bfloat16"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_twin_matches_pallas_interpret(name):
    B, L_in, C_in, C, upsample, post, resblock2, dtype = CASES[name]
    x, weights, ups, pst = _case(7, B, L_in, C_in, C, upsample, post, resblock2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    want = np.asarray(
        jax_fused_mrf(
            jnp.asarray(x).astype(jdt), _to(weights, jnp.asarray), KERNEL_SIZES, DILATIONS,
            upsample=_to(ups, jnp.asarray), post=_to(pst, jnp.asarray),
            compute_dtype=jdt, interpret=True,
        ).astype(jnp.float32)
    )
    tw, tu, tp = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy),
        _to(pst, torch.from_numpy), tdt,
    )
    got = mrf.fused_mrf(
        torch.from_numpy(x).to(tdt), tw, KERNEL_SIZES, DILATIONS,
        upsample=tu, post=tp, compute_dtype=tdt,
    )
    L = L_in * (upsample[1] if upsample else 1)
    assert tuple(got.shape) == want.shape == (B, L, 1 if post else C)
    assert got.dtype == (torch.float32 if post else tdt)
    scale = max(float(np.abs(want).max()), 1.0)
    tol = 0.02 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale)


@pytest.mark.parametrize("k,u", [(16, 8), (4, 2)])
def test_conv_transpose_same_matches_lax(k, u):
    """The twin's ConvTranspose (flipped torch weight, cropped full output)
    is JAX's ``conv_transpose(..., "SAME")``."""
    import jax

    rng = np.random.RandomState(k)
    x = rng.randn(2, 9, 5).astype(np.float32)
    w = rng.randn(k, 5, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    want = np.asarray(
        jax.lax.conv_transpose(
            jnp.asarray(x), jnp.asarray(w), strides=(u,), padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
        )
        + b
    )
    got = mrf.conv_transpose_same(
        torch.from_numpy(x).transpose(1, 2),
        mrf.convt_weight_to_torch(torch.from_numpy(w)), torch.from_numpy(b), u,
    ).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_cpu_tensors_take_the_plain_twin():
    x, weights, ups, pst = _case(3, 1, 16, 8, 4, (4, 2), True)
    tw, tu, tp = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), _to(pst, torch.from_numpy)
    )
    launches, plain = mrf.fused_mrf.launches, mrf.fused_mrf.plain_calls
    mrf.fused_mrf(torch.from_numpy(x), tw, KERNEL_SIZES, DILATIONS, upsample=tu, post=tp)
    assert mrf.fused_mrf.launches == launches
    assert mrf.fused_mrf.plain_calls == plain + 1


def test_wrapper_rejects_mismatched_storage():
    x, weights, _, _ = _case(4, 1, 32, 8, 8, None, False)
    tw, _, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy), compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x must be"):
        mrf.fused_mrf(torch.from_numpy(x), tw, KERNEL_SIZES, DILATIONS, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="is torch.bfloat16, want torch.float32"):
        mrf.fused_mrf(torch.from_numpy(x), tw, KERNEL_SIZES, DILATIONS)
