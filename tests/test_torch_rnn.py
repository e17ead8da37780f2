"""PyTorch port of the LSTM primitives against ``viettts_tpu.ops.rnn``.

Inputs are made with numpy from a seed and fed to both frameworks.  The
tolerance is 1e-5 absolute: both sides run the same float32 math on the
CPU, only the summation order of the matmuls differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viettts_tpu.ops import rnn as jax_rnn
from viettts_tpu_torch.ops import rnn as torch_rnn

ATOL = 1e-5


def _params(rng, D, H):
    w_i = (rng.randn(D, 4 * H) * 0.3).astype(np.float32)
    w_h = (rng.randn(H, 4 * H) * 0.3).astype(np.float32)
    b = (rng.randn(4 * H) * 0.1).astype(np.float32)
    jax_p = jax_rnn.LSTMParams(jnp.asarray(w_i), jnp.asarray(w_h), jnp.asarray(b))
    torch_p = torch_rnn.LSTM(D, H)
    with torch.no_grad():
        torch_p.w_i.copy_(torch.from_numpy(w_i))
        torch_p.w_h.copy_(torch.from_numpy(w_h))
        torch_p.b.copy_(torch.from_numpy(b))
    return jax_p, torch_p


@pytest.mark.parametrize("reverse,with_reset", [(False, False), (True, False), (True, True)])
def test_unroll_lstm_matches_jax(reverse, with_reset):
    rng = np.random.RandomState(0)
    B, L, D, H = 3, 11, 6, 8
    jax_p, torch_p = _params(rng, D, H)
    xs = rng.randn(B, L, D).astype(np.float32)
    reset = rng.rand(B, L) < 0.2 if with_reset else None

    want, _ = jax_rnn.unroll_lstm(
        jax_p, jnp.asarray(xs), reverse=reverse,
        reset_mask=None if reset is None else jnp.asarray(reset),
    )
    with torch.no_grad():
        got = torch_rnn.unroll_lstm(
            torch_p, torch.from_numpy(xs), reverse=reverse,
            reset_mask=None if reset is None else torch.from_numpy(reset),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bidirectional_lstm_matches_jax_on_real_positions():
    """Unequal lengths: the backward direction resets at each row's last
    real token, so real positions agree; padding positions are garbage on
    both sides and are not compared."""
    rng = np.random.RandomState(1)
    B, L, D, H = 3, 10, 5, 7
    fwd_j, fwd_t = _params(rng, D, H)
    bwd_j, bwd_t = _params(rng, D, H)
    xs = rng.randn(B, L, D).astype(np.float32)
    lengths = np.asarray([10, 6, 1], np.int64)

    want = np.asarray(
        jax_rnn.bidirectional_lstm(fwd_j, bwd_j, jnp.asarray(xs), jnp.asarray(lengths))
    )
    with torch.no_grad():
        got = torch_rnn.bidirectional_lstm(
            fwd_t, bwd_t, torch.from_numpy(xs), torch.from_numpy(lengths)
        ).numpy()
    assert got.shape == want.shape == (B, L, 2 * H)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=ATOL)
