"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``; each test skips without a CUDA device.  The file imports
neither jax nor the JAX package, so on a machine with a GPU and no jax it
runs on its own, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Shapes are small and ragged (lengths that are not tile multiples, widths
that are not powers of two) to reach the kernels' edge handling; the main
path's shapes are checked by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from viettts_tpu_torch.ops import ar_decoder, mrf

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _w(rng, *shape, s=1.0):
    return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))


@pytest.mark.parametrize("B,L,H,P,D", [(3, 37, 64, 32, 20), (1, 130, 96, 48, 80)])
def test_ar_decode_kernel_matches_twin(cuda, B, L, H, P, D):
    """float32 against float32: 1e-4 absolute over a short recurrence."""
    rng = np.random.RandomState(0)
    args = [
        _w(rng, B, L, 4 * H, s=0.5), _w(rng, B, L, 4 * H, s=0.5),
        torch.from_numpy(rng.rand(L, B, P) < 0.5), torch.from_numpy(rng.rand(L, B, P) < 0.5),
        _w(rng, D, P, s=D ** -0.5), _w(rng, P, P, s=P ** -0.5),
        _w(rng, P + H, 4 * H, s=(P + H) ** -0.5), _w(rng, P + 2 * H, 4 * H, s=(P + 2 * H) ** -0.5),
        _w(rng, 2 * H, D, s=(2 * H) ** -0.5), _w(rng, D, s=0.1),
    ]
    args = [a.to(cuda) for a in args]
    launches, plain = ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls
    got = ar_decoder.ar_decode(*args, 2.0)
    torch.cuda.synchronize()
    assert (ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls) == (launches + 1, plain)
    want = ar_decoder.ar_decode_plain(*args, 2.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_ar_decode_kernel_refuses_unsupported_width(cuda):
    H, P, D, B, L = 40, 8, 4, 1, 3  # H not a multiple of 32
    args = [
        torch.zeros(B, L, 4 * H), torch.zeros(B, L, 4 * H),
        torch.ones(L, B, P, dtype=torch.bool), torch.ones(L, B, P, dtype=torch.bool),
        torch.zeros(D, P), torch.zeros(P, P), torch.zeros(P + H, 4 * H),
        torch.zeros(P + 2 * H, 4 * H), torch.zeros(2 * H, D), torch.zeros(D),
    ]
    plain = ar_decoder.ar_decode.plain_calls
    with pytest.raises(ValueError, match="H % 32 == 0"):
        ar_decoder.ar_decode(*[a.to(cuda) for a in args], 1.0)
    assert ar_decoder.ar_decode.plain_calls == plain


def _stage(rng, C_in, C, k_u, u, post, resblock2, kernel_sizes, dilations):
    weights = []
    for k, dils in zip(kernel_sizes, dilations):
        n, s = len(dils), 0.5 / np.sqrt(k * C)
        w2 = None if resblock2 else _w(rng, n, k, C, C, s=s)
        b2 = None if resblock2 else _w(rng, n, C, s=0.05)
        weights.append((_w(rng, n, k, C, C, s=s), _w(rng, n, C, s=0.05), w2, b2))
    ups = (_w(rng, k_u, C_in, C, s=(k_u * C_in / u) ** -0.5), _w(rng, C, s=0.05), u) if k_u else None
    pst = (_w(rng, 7, C, 1, s=(7 * C) ** -0.5), _w(rng, 1, s=0.05)) if post else None
    return weights, ups, pst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,L_in,C_in,C,k_u,u,post,resblock2",
    [
        (2, 37, 48, 24, 16, 8, False, False),  # prologue (16, 8), ragged tiles
        (1, 300, 20, 12, 4, 2, True, False),   # prologue (4, 2) + epilogue
        (2, 77, 16, 16, 0, 1, False, True),    # bare MRF, ResBlock2
        (1, 130, 40, 40, 0, 1, True, False),   # bare MRF + epilogue, C % 32 != 0
    ],
)
def test_fused_mrf_kernel_matches_twin(cuda, dtype, B, L_in, C_in, C, k_u, u, post, resblock2):
    """f32: rtol 1e-5 with atol 1e-4 (TF32 off); bf16 storage: 0.02 of the
    output scale, the bar of tests/test_mrf.py."""
    rng = np.random.RandomState(1)
    kernel_sizes, dilations = (3, 7, 11), ((1, 3, 5),) * 3
    weights, ups, pst = _stage(rng, C_in, C, k_u, u, post, resblock2, kernel_sizes, dilations)
    tw, tu, tp = mrf.prepare_mrf_weights(
        [tuple(None if t is None else t.to(cuda) for t in blk) for blk in weights],
        None if ups is None else (ups[0].to(cuda), ups[1].to(cuda), u),
        None if pst is None else (pst[0].to(cuda), pst[1].to(cuda)),
        dtype,
    )
    x = _w(rng, B, L_in, C_in if k_u else C).to(cuda, dtype)
    kw = dict(upsample=tu, post=tp, compute_dtype=dtype)
    launches, plain = mrf.fused_mrf.launches, mrf.fused_mrf.plain_calls
    got = mrf.fused_mrf(x, tw, kernel_sizes, dilations, **kw)
    torch.cuda.synchronize()
    assert (mrf.fused_mrf.launches, mrf.fused_mrf.plain_calls) == (launches + 1, plain)
    want = mrf.fused_mrf_plain(x, tw, kernel_sizes, dilations, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        scale = max(want.float().abs().max().item(), 1.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0.02 * scale)
