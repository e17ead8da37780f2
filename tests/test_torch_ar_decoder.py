"""Kernel K1's plain twin (``ar_decode_plain``) against the JAX Pallas
``ar_decode`` in interpret mode, with the same numpy keep-masks fed to
both, and the CPU dispatch of the ``ar_decode`` wrapper."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viettts_tpu.ops.ar_decoder import ar_decode as jax_ar_decode
from viettts_tpu_torch.ops import ar_decoder

H, P, D, L = 32, 8, 16, 64


def _inputs(B, dropout_on, seed=0):
    rng = np.random.RandomState(seed)

    def w(*shape, s=0.3):
        return (rng.randn(*shape) * s).astype(np.float32)

    keep_shape = (L, B, P)
    if dropout_on:
        keep1, keep2 = rng.rand(*keep_shape) < 0.5, rng.rand(*keep_shape) < 0.5
    else:
        keep1 = keep2 = np.ones(keep_shape, bool)
    return dict(
        g1c=w(B, L, 4 * H), g2c=w(B, L, 4 * H), keep1=keep1, keep2=keep2,
        k_fc1=w(D, P), k_fc2=w(P, P),
        w1_p=w(P, 4 * H, s=0.2), wh1=w(H, 4 * H, s=0.2),
        w2_p=w(P, 4 * H, s=0.2), w2_h1=w(H, 4 * H, s=0.2), wh2=w(H, 4 * H, s=0.2),
        proj_kernel=w(2 * H, D), proj_bias=w(D, s=0.1),
        scale=2.0 if dropout_on else 1.0,
    )


def _torch_args(a):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items() if k != "scale"}
    w1m = torch.cat([t["w1_p"], t["wh1"]], 0)
    w2m = torch.cat([t["w2_p"], t["w2_h1"], t["wh2"]], 0)
    return (
        t["g1c"], t["g2c"], t["keep1"], t["keep2"], t["k_fc1"], t["k_fc2"],
        w1m, w2m, t["proj_kernel"], t["proj_bias"], a["scale"],
    )


@pytest.mark.parametrize("dropout_on,B", [(True, 2), (False, 2), (True, 1), (False, 1)])
def test_plain_twin_matches_pallas_interpret(dropout_on, B):
    """atol 5e-5, the bar of tests/test_ar_decoder.py: a 64-frame float32
    recurrence with the same math, differently ordered sums."""
    a = _inputs(B, dropout_on)
    want = np.asarray(
        jax_ar_decode(
            *(jnp.asarray(a[k]) for k in (
                "g1c", "g2c", "keep1", "keep2", "k_fc1", "k_fc2", "w1_p", "wh1",
                "w2_p", "w2_h1", "wh2", "proj_kernel", "proj_bias",
            )),
            a["scale"], interpret=True,
        )
    )
    with torch.no_grad():
        got = ar_decoder.ar_decode_plain(*_torch_args(a)).numpy()
    assert got.shape == want.shape == (B, L, D)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_cpu_tensors_take_the_plain_twin():
    args = _torch_args(_inputs(1, True, seed=1))
    launches, plain = ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls
    with torch.no_grad():
        got = ar_decoder.ar_decode(*args)
        want = ar_decoder.ar_decode_plain(*args)
    assert ar_decoder.ar_decode.launches == launches
    assert ar_decoder.ar_decode.plain_calls == plain + 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "index,bad,match",
    [
        (0, lambda t: t[:, :-1], "g2c has shape"),  # g1c length no longer matches
        (2, lambda t: t.float(), "keep1 is torch.float32"),
        (6, lambda t: t.t().contiguous().t(), "w1m is not contiguous"),
        (9, lambda t: t[:-1], "proj_bias has shape"),
    ],
)
def test_wrapper_rejects_bad_inputs(index, bad, match):
    args = list(_torch_args(_inputs(1, False)))
    args[index] = bad(args[index])
    with pytest.raises(ValueError, match=match):
        ar_decoder.ar_decode(*args)
