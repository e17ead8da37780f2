"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``; each test skips without a CUDA device.  The file imports
neither jax nor the JAX package, so on a machine with a GPU and no jax it
runs on its own, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

Shapes are small and ragged (lengths that are not tile multiples, widths
that are not powers of two) to reach the kernels' edge handling, plus the
main path's stage widths at short lengths; the main path's full shapes are
checked by ``chip_smoke.py``.
"""

import copy
import ctypes

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from viettts_tpu_torch.ops import _build, ar_decoder, mrf, rnn

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


def _ar_args(rng, B, L, H, P, D, dev):
    args = [
        _w(rng, B, L, 4 * H, s=0.5), _w(rng, B, L, 4 * H, s=0.5),
        torch.from_numpy(rng.rand(L, B, P) < 0.5), torch.from_numpy(rng.rand(L, B, P) < 0.5),
        _w(rng, D, P, s=D ** -0.5), _w(rng, P, P, s=P ** -0.5),
        _w(rng, P + H, 4 * H, s=(P + H) ** -0.5), _w(rng, P + 2 * H, 4 * H, s=(P + 2 * H) ** -0.5),
        _w(rng, 2 * H, D, s=(2 * H) ** -0.5), _w(rng, D, s=0.1),
    ]
    return [a.to(dev) for a in args]


@pytest.mark.parametrize(
    "B,L,H,P,D",
    [
        (3, 37, 64, 32, 20),  # one unit per CTA, 64 CTAs
        (1, 130, 96, 48, 80),  # more projection columns than prenet columns
        (11, 23, 64, 32, 20),  # two batch chunks: the shadow work restages
        (2, 19, 270, 40, 24),  # 4 units per CTA, the last CTA holds 2; idle prenet CTAs
        (1, 48, 512, 256, 80),  # the main path's widths: 128 CTAs
        (16, 24, 512, 256, 80),  # the server's max_batch
        (70, 5, 64, 32, 20),  # more rows than one launch takes: two launches
    ],
)
def test_ar_decode_kernel_matches_twin(cuda, B, L, H, P, D):
    """float32 against float32: 1e-4 absolute over the recurrence."""
    args = _ar_args(np.random.RandomState(0), B, L, H, P, D, cuda)
    launches, plain = ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls
    got = ar_decoder.ar_decode(*args, 2.0)
    torch.cuda.synchronize()
    n = -(-B // ar_decoder.MAX_ROWS)
    assert (ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls) == (launches + n, plain)
    want = ar_decoder.ar_decode_plain(*args, 2.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_ar_decode_kernel_is_deterministic(cuda):
    """Every sum runs in a fixed order inside one CTA: two launches on the
    same inputs give the same bits."""
    args = _ar_args(np.random.RandomState(1), 4, 64, 512, 256, 80, cuda)
    first = ar_decoder.ar_decode(*args, 2.0)
    second = ar_decoder.ar_decode(*args, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("B", [1, 4])
def test_ar_decode_kernel_under_a_smaller_cards_plan(cuda, B):
    """The plan of a 114-SM card (103 CTAs of 5 hidden units, the last
    holding 2; 8 staged rows) forced on this card: one co-resident
    cooperative launch, within 1e-4 of the twin and bitwise run to run."""
    H, P, D, L = 512, 256, 80, 64
    plan = ar_decoder.plan_decode(H, P, D, 114, B)
    assert (plan.ctas, plan.units) == (103, 5)
    args = _ar_args(np.random.RandomState(2), B, L, H, P, D, cuda)
    launches, plain = ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls
    got = ar_decoder.ar_decode(*args, 2.0, num_sms=114)
    again = ar_decoder.ar_decode(*args, 2.0, num_sms=114)
    torch.cuda.synchronize()
    assert (ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls) == (launches + 2, plain)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ar_decoder.ar_decode_plain(*args, 2.0), rtol=0, atol=1e-4)


def test_ar_decode_kernel_refuses_unsupported_width(cuda):
    """H=8192 at 64 rows: a CTA's state rows and staged vector alone exceed
    the shared memory of a block, with every gate block streamed; the
    wrapper raises without launching or running the twin."""
    H, P, D, B, L = 8192, 256, 80, 64, 1
    shapes = [(B, L, 4 * H), (B, L, 4 * H), (D, P), (P, P), (P + H, 4 * H), (P + 2 * H, 4 * H), (2 * H, D), (D,)]
    zeros = [torch.zeros(s, device=cuda) for s in shapes]
    keep = torch.ones(L, B, P, dtype=torch.bool, device=cuda)
    launches, plain = ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls
    with pytest.raises(ValueError, match="bytes of shared memory per CTA"):
        ar_decoder.ar_decode(*zeros[:2], keep, keep, *zeros[2:], 1.0, num_sms=86)
    assert (ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls) == (launches, plain)


def _wide_case(cuda, seed, B, L, H, num_sms=None):
    """K1 at a width whose gate columns do not all fit shared memory: one
    launch per 64 rows and no twin call, within 1e-4 of the twin and two
    launches bitwise equal.  Returns the plan."""
    P, D = 256, 80
    sms = num_sms or torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ar_decoder.plan_decode(H, P, D, sms, min(B, ar_decoder.MAX_ROWS))
    assert plan.streamed, plan
    args = _ar_args(np.random.RandomState(seed), B, L, H, P, D, cuda)
    launches, plain = ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls
    got = ar_decoder.ar_decode(*args, 2.0, num_sms=num_sms)
    again = ar_decoder.ar_decode(*args, 2.0, num_sms=num_sms)
    torch.cuda.synchronize()
    n = -(-B // ar_decoder.MAX_ROWS)
    assert (ar_decoder.ar_decode.launches, ar_decoder.ar_decode.plain_calls) == (launches + 2 * n, plain)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ar_decoder.ar_decode_plain(*args, 2.0), rtol=0, atol=1e-4)
    return plan


def test_ar_decode_kernel_runs_tacotron2_width(cuda):
    """H=1024, Tacotron 2's decoder width: 2 column groups of 4 units a
    CTA on 132 SMs, the gate blocks that do not fit shared memory streamed
    every frame; within 1e-4 of the twin and bitwise run to run."""
    plan = _wide_case(cuda, 5, 1, 48, 1024)
    assert plan.groups >= 2


@pytest.mark.parametrize("B", [1, 4, 16, 64])
@pytest.mark.parametrize("H", [768, 1024])
def test_ar_decode_wide_kernel_matches_twin(cuda, H, B):
    """H=768 and 1024 at every batch of the main path: the streamed plans
    (fewer staged rows, more of the gate blocks streamed as B grows)."""
    _wide_case(cuda, 6, B, 40, H)


@pytest.mark.parametrize("B", [1, 4])
def test_ar_decode_wide_kernel_under_a_smaller_cards_plan(cuda, B):
    """H=1024 under the 114-SM plan (103 CTAs of 2 groups of 5 units)
    forced on this card."""
    plan = _wide_case(cuda, 7, B, 40, 1024, num_sms=114)
    assert (plan.ctas, plan.units, plan.groups) == (103, 10, 2)


@pytest.mark.parametrize("B", [1, 4])
def test_ar_decode_kernel_at_2048_streams_the_chain(cuda, B):
    """H=2048: the chain's W2h1 block streams too (218 MB of gate columns,
    more than L2); a short decode."""
    plan = _wide_case(cuda, 8, B, 12, 2048)
    assert plan.streamed & 0b00100


def test_ar_decode_wide_kernel_replays_in_a_cuda_graph(cuda):
    """A streamed plan captured in a CUDA graph after one eager launch (its
    opt-in and occupancy check): the replay rewrites its streamed buffer
    and exchange and gives the eager launch's bits, twice."""
    H, P, D, B, L = 1024, 256, 80, 2, 24
    args = _ar_args(np.random.RandomState(9), B, L, H, P, D, cuda)
    eager = ar_decoder.ar_decode(*args, 2.0)
    torch.cuda.synchronize()
    launches = ar_decoder.ar_decode.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ar_decoder.ar_decode(*args, 2.0)
    assert ar_decoder.ar_decode.launches == launches + 1
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def _lstm_case(seed, B, T, H, D, dev):
    """Both directions' weights at the encoders' scale (sigma 1/sqrt(D + H)),
    inputs and lengths that include T, 0 and 1 (B=1: T)."""
    rng = np.random.RandomState(seed)
    params = []
    for _ in range(2):
        p = rnn.LSTM(D, H)
        with torch.no_grad():
            p.w_i.copy_(_w(rng, D, 4 * H, s=(D + H) ** -0.5))
            p.w_h.copy_(_w(rng, H, 4 * H, s=(D + H) ** -0.5))
            p.b.copy_(_w(rng, 4 * H, s=0.1))
        params.append(p.to(dev))
    lengths = np.r_[[T, 0, 1], rng.randint(0, T + 1, max(B - 3, 0))][:B]
    return params, _w(rng, B, T, D).to(dev), torch.from_numpy(lengths).to(dev)


def _lstm_counts():
    return rnn.bidirectional_lstm.launches, rnn.bidirectional_lstm.plain_calls


@pytest.mark.parametrize("H", [32, 256, 512])
@pytest.mark.parametrize("T", [1, 7, 64, 256])
@pytest.mark.parametrize("B", [1, 3, 64])
def test_bilstm_kernel_matches_the_loop(cuda, B, T, H):
    """One launch of csrc/lstm.cu against the loop, every position (padded
    ones too) within tests/test_torch_rnn.py's 1e-5."""
    params, xs, lengths = _lstm_case(B * 1000 + T + H, B, T, H, 40, cuda)
    with torch.inference_mode():
        before = _lstm_counts()
        got = rnn.bidirectional_lstm(*params, xs, lengths)
        torch.cuda.synchronize()
        assert _lstm_counts() == (before[0] + 1, before[1])
        want = rnn.bidirectional_lstm_plain(*params, xs, lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_bilstm_kernel_is_bitwise_run_to_run(cuda):
    """Every dot is summed in a fixed order inside one CTA: two launches at
    the bulk cells' shape give the same bits."""
    params, xs, lengths = _lstm_case(11, 64, 256, 256, 256, cuda)
    with torch.inference_mode():
        first = rnn.bidirectional_lstm(*params, xs, lengths)
        second = rnn.bidirectional_lstm(*params, xs, lengths)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_bilstm_kernel_replays_in_a_cuda_graph(cuda):
    """Captured after one eager launch (its opt-in and occupancy check):
    the capture counts one launch and every replay gives the eager bits."""
    params, xs, lengths = _lstm_case(12, 1, 64, 256, 256, cuda)
    with torch.inference_mode():
        eager = rnn.bidirectional_lstm(*params, xs, lengths)
        torch.cuda.synchronize()
        launches = rnn.bidirectional_lstm.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = rnn.bidirectional_lstm(*params, xs, lengths)
        assert rnn.bidirectional_lstm.launches == launches + 1
        for _ in range(2):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, eager)


def test_bilstm_on_the_card_takes_the_loop_where_a_gradient_is_needed(cuda):
    """Under autograd with weights that require grad the card runs the
    loop, in float32 and in bfloat16; bfloat16 in inference raises and
    runs nothing; more than 64 rows take one launch per 64."""
    params, xs, lengths = _lstm_case(13, 70, 9, 32, 16, cuda)
    half = [copy.deepcopy(p).to(torch.bfloat16) for p in params]
    before = _lstm_counts()
    trained = rnn.bidirectional_lstm(*params, xs, lengths)
    assert trained.requires_grad and _lstm_counts() == (before[0], before[1] + 1)
    trained = rnn.bidirectional_lstm(*half, xs.bfloat16(), lengths)
    assert trained.requires_grad and trained.dtype == torch.bfloat16
    assert _lstm_counts() == (before[0], before[1] + 2)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="torch.bfloat16 on cuda"):
            rnn.bidirectional_lstm(*half, xs.bfloat16(), lengths)
        assert _lstm_counts() == (before[0], before[1] + 2)
        got = rnn.bidirectional_lstm(*params, xs, lengths)
        assert _lstm_counts() == (before[0] + 2, before[1] + 2)
        torch.testing.assert_close(got, rnn.bidirectional_lstm_plain(*params, xs, lengths), rtol=0, atol=1e-5)


def test_bilstm_kernel_refuses_a_wider_lstm(cuda):
    """H=640 in inference raises with the width, launching nothing and
    never falling back to the loop."""
    params, xs, lengths = _lstm_case(14, 2, 3, 640, 8, cuda)
    before = _lstm_counts()
    with torch.inference_mode(), pytest.raises(ValueError, match="H=640"):
        rnn.bidirectional_lstm(*params, xs, lengths)
    assert _lstm_counts() == before


def _rel_rms(got, want):
    return ((got - want).square().mean().sqrt() / want.square().mean().sqrt().clamp_min(1e-30)).item()


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
        # the main path's four stages (default widths), short lengths
        (1, 40, 512, 256, 16, 8, False, False),
        (2, 9, 256, 128, 16, 8, False, False),
        (1, 300, 128, 64, 4, 2, False, True),
        (2, 260, 64, 32, 4, 2, True, False),
    ],
)
def test_fused_mrf_kernel_matches_twin(cuda, dtype, B, L_in, C_in, C, k_u, u, post, resblock2):
    """f32 (3xTF32 dots): rtol 1e-5 with atol 1e-4 against the float32 twin
    (cuDNN TF32 off); bf16 (bf16 operand dots): 0.02 of the output scale
    against the float32 twin, the bar of tests/test_mrf.py, and rel-RMS
    1e-3 against the twin that rounds the dot operands as the kernel does
    (``bf16_dots``): the same function, summed in another order."""
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
        rounded = mrf.fused_mrf_plain(x, tw, kernel_sizes, dilations, bf16_dots=True, **kw)
        assert _rel_rms(got.float(), rounded.float()) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [12, 72])
@pytest.mark.parametrize("tile", range(5))
def test_mrf_conv_every_tile_matches_twin(cuda, dtype, C, tile):
    """One MRF conv (bias and residual) in each tile shape of the kernel,
    against a float32 conv of the operands the kernel multiplies: bf16
    rounding of lrelu(x) and of the weights, or the full float32 values
    for 3xTF32.  Only the order of the float32 sums differs.  C = 12 takes
    the scalar weight loads of the bf16 route, C = 72 a partial chunk."""
    rng = np.random.RandomState(4)
    B, L, k, d = 2, 203, 7, 3
    x = _w(rng, B, L, C).to(cuda)
    w = _w(rng, k, C, C, s=0.5 / np.sqrt(k * C)).to(cuda)
    b = _w(rng, C, s=0.05).to(cuda)
    res = _w(rng, B, L, C).to(cuda)
    inp = F.leaky_relu(x, 0.1)
    if dtype == torch.bfloat16:
        wk = w.to(torch.bfloat16)
        inp, wd = inp.to(torch.bfloat16).float(), wk.float()
    else:
        wk, wd = mrf.tf32_split(w[None])[0], w
    want = F.conv1d(inp.transpose(1, 2), wd.permute(2, 1, 0), b, padding=d * (k - 1) // 2, dilation=d)
    want = want.transpose(1, 2) + res
    y = torch.empty_like(x)
    lib = _build.load_library()
    _build.check(
        lib.viettts_mrf_conv(
            int(dtype == torch.bfloat16), 0, x.data_ptr(), wk.data_ptr(), b.data_ptr(), res.data_ptr(),
            y.data_ptr(), None, B, L, C, C, k, d, 0, tile, 1.0, _build.stream_ptr(x.device),
        ),
        "mrf conv",
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_u,u,C_in,C", [(16, 8, 48, 24), (4, 2, 20, 12)])
@pytest.mark.parametrize("tile", range(5))
def test_mrf_convt_every_tile_matches_twin(cuda, dtype, k_u, u, C_in, C, tile):
    """The float routes' ConvTranspose prologue (u interleaved stride-1
    convs on the tensor cores) in each tile shape, against the twin's
    ConvTranspose of the operands the kernel multiplies, as above."""
    rng = np.random.RandomState(5)
    B, L_in = 2, 37
    x = _w(rng, B, L_in, C_in).to(cuda)
    w = _w(rng, k_u, C_in, C, s=(k_u * C_in / u) ** -0.5).to(cuda)
    b = _w(rng, C, s=0.05).to(cuda)
    inp = F.leaky_relu(x, 0.1)
    if dtype == torch.bfloat16:
        wk = w.to(torch.bfloat16)
        inp, wd = inp.to(torch.bfloat16).float(), wk.float()
    else:
        wk, wd = mrf.tf32_split(w[None])[0], w
    want = mrf.conv_transpose_same(inp.transpose(1, 2), mrf.convt_weight_to_torch(wd), b, u).transpose(1, 2)
    y = torch.empty(B, L_in * u, C, device=cuda)
    lib = _build.load_library()
    _build.check(
        lib.viettts_mrf_convt_mma(
            int(dtype == torch.bfloat16), x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(),
            B, L_in, C_in, C, k_u, u, mrf.convt_lead_pad(k_u, u), tile, _build.stream_ptr(x.device),
        ),
        "mrf prologue",
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("C", [12, 72])
@pytest.mark.parametrize("tile", range(5))
def test_mrf_conv_int8_every_tile_matches_twin(cuda, mode, C, tile):
    """One int8 MRF conv (bias and residual) in each tile shape of K3's
    tensor-core kernel, against the twin's ``_conv_int8`` on the same
    float32 input: bitwise equal, since the integer dot is exact and every
    float32 step runs in the same order.  C = 12 takes the scalar loads (and
    32-channel chunks in tile 2), C = 72 a partial 64-channel chunk; the
    static scale is 0.8 of the input's amax, so that some inputs clip."""
    rng = np.random.RandomState(6)
    B, L, k, d = 2, 203, 7, 3
    x = _w(rng, B, L, C).to(cuda)
    w = _w(rng, k, C, C, s=0.5 / np.sqrt(k * C)).to(cuda)
    b = _w(rng, C, s=0.05).to(cuda)
    res = _w(rng, B, L, C).to(cuda)
    q = mrf.quantize_weight_int8(w)
    inp = F.leaky_relu(x, 0.1)
    if mode == "static":
        act = 0.8 * inp.abs().amax()
        amax, stride = act.reshape(1), 0
    else:
        act = None
        amax, stride = inp.abs().amax(dim=(1, 2)).contiguous(), 1
    want = mrf._conv_int8(inp.transpose(1, 2), q.codes, q.scales, b, d, act).transpose(1, 2) + res
    y = torch.empty_like(x)
    lib = _build.load_library()
    _build.check(
        lib.viettts_mrf_conv_int8(
            0, x.data_ptr(), q.kmajor.data_ptr(), q.scales.data_ptr(), b.data_ptr(), amax.data_ptr(),
            stride, int(act is None), res.data_ptr(), y.data_ptr(), None, B, L, C, C, k, d, 0, tile, 1.0,
            _build.stream_ptr(x.device),
        ),
        "int8 conv",
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def _int8_codes(t, act):
    """The int8 codes of lrelu(t) [B, L, C] at the amax ``act`` (static) or
    at each batch row's amax (``act`` None), as the twin quantizes."""
    y = F.leaky_relu(t, 0.1)
    c127 = torch.tensor(127.0, device=t.device)
    if act is not None:
        return torch.round(torch.clamp(y * (c127 / act.clamp_min(1e-12)), -127.0, 127.0))
    return torch.round(y * (c127 / y.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)))


@pytest.mark.parametrize("k_u,u,C_in,C", [(16, 8, 48, 24), (4, 2, 20, 12)])
@pytest.mark.parametrize("tile", range(5))
def test_mrf_convt_f64_every_tile_matches_twin(cuda, k_u, u, C_in, C, tile):
    """The int8 route's ConvTranspose prologue (float64 sums on the FP64
    tensor cores) in each tile shape, against the twin's float64
    ConvTranspose rounded once to float32: the products are exact in
    float64 and only the order of the float64 sums differs, so the outputs
    are equal but where a sum lies within ~1e-16 of a float32 rounding
    boundary, and the int8 codes of the first conv's input are equal."""
    rng = np.random.RandomState(7)
    B, L_in = 2, 37
    x = _w(rng, B, L_in, C_in).to(cuda)
    w = _w(rng, k_u, C_in, C, s=(k_u * C_in / u) ** -0.5).to(cuda)
    b = _w(rng, C, s=0.05).to(cuda)
    _, (w_t, b_t, _), _ = mrf.prepare_mrf_weights([], (w, b, u), quantize_int8=True)
    got = mrf.convt_f64(x, w_t, b_t, u, tile=tile)
    zero = torch.zeros(C, dtype=torch.float64, device=cuda)
    want = mrf.conv_transpose_same(
        F.leaky_relu(x, 0.1).transpose(1, 2).double(), mrf.convt_weight_to_torch(w).double(), zero, u
    ).float() + b[None, :, None]
    want = want.transpose(1, 2)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, L_in * u, C)
    torch.testing.assert_close(got, want, rtol=2.0 ** -22, atol=1e-7)
    act = F.leaky_relu(want, 0.1).abs().amax()
    for a in (act, 0.5 * act, None):
        assert torch.equal(_int8_codes(got, a), _int8_codes(want, a))


@pytest.mark.parametrize("mode", ["static", "dynamic", "static_4x"])
@pytest.mark.parametrize(
    "B,L_in,C_in,C,k_u,u,post,resblock2",
    [
        (2, 37, 48, 24, 16, 8, False, False),  # prologue (16, 8), ragged tiles
        (1, 300, 20, 12, 4, 2, True, False),   # prologue (4, 2) + epilogue, C % 32 != 0
        (2, 77, 16, 16, 0, 1, False, True),    # bare MRF, ResBlock2
        (1, 130, 40, 40, 0, 1, True, False),   # bare MRF + epilogue
    ],
)
def test_fused_mrf_int8_kernel_matches_twin(cuda, mode, B, L_in, C_in, C, k_u, u, post, resblock2):
    """K3 (bf16 storage, int8 MRF convs) against the twin: rel-RMS 1e-3 and
    max abs 0.02 of the output scale.  Both compute the integer dots
    exactly and the float32 steps in the same order, so they differ only
    where an upstream float32 sum rounds differently and flips an int8
    code.  ``static_4x`` feeds 4x the calibration input: it must clip, and
    stay finite."""
    rng = np.random.RandomState(2)
    kernel_sizes, dilations = (3, 7, 11), ((1, 3, 5),) * 3
    weights, ups, pst = _stage(rng, C_in, C, k_u, u, post, resblock2, kernel_sizes, dilations)
    weights = [tuple(None if t is None else t.to(cuda) for t in blk) for blk in weights]
    ups = None if ups is None else (ups[0].to(cuda), ups[1].to(cuda), u)
    pst = None if pst is None else (pst[0].to(cuda), pst[1].to(cuda))
    x = _w(rng, B, L_in, C_in if k_u else C).to(cuda)
    act = None
    if mode != "dynamic":
        _, amax = mrf.mrf_walk(x.transpose(1, 2), weights, kernel_sizes, dilations,
                               lambda j, y: y.abs().amax(), upsample=ups)
        act = torch.stack(amax)
    if mode == "static_4x":
        x = 4.0 * x
        _, clipped = mrf.mrf_walk(x.transpose(1, 2), weights, kernel_sizes, dilations,
                                  lambda j, y: (y.abs() > act[j]).float().mean(), upsample=ups)
        assert max(c.item() for c in clipped) > 0.01
    tw, tu, tp = mrf.prepare_mrf_weights(weights, ups, pst, torch.bfloat16, quantize_int8=True)
    x = x.to(torch.bfloat16)
    kw = dict(upsample=tu, post=tp, compute_dtype=torch.bfloat16, quantize_int8=True, act_scales=act)
    counts = (mrf.fused_mrf.int8_launches, mrf.fused_mrf.plain_calls)
    got = mrf.fused_mrf(x, tw, kernel_sizes, dilations, **kw)
    torch.cuda.synchronize()
    assert (mrf.fused_mrf.int8_launches, mrf.fused_mrf.plain_calls) == (counts[0] + 1, counts[1])
    want = mrf.fused_mrf_plain(x, tw, kernel_sizes, dilations, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    scale = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= 0.02 * scale
    assert _rel_rms(got, want) <= 1e-3


@pytest.mark.parametrize("C", [32, 128, 40])
def test_fused_mrf_int8_bare_static_is_exact(cuda, C):
    """Without a prologue the stage input reaches K3 and the twin as the
    same float32 values, so no code can flip: the outputs are equal.  C =
    32 runs the fused pipeline (one launch for the stage), C = 128 the
    per-conv wgmma pipeline and C = 40 mma_conv_kernel: each bitwise the
    twin, so the pipelines agree bitwise."""
    rng = np.random.RandomState(3)
    kernel_sizes, dilations = (3, 7, 11), ((1, 3, 5),) * 3
    weights, _, _ = _stage(rng, 0, C, 0, 1, False, False, kernel_sizes, dilations)
    weights = [tuple(t.to(cuda) for t in blk) for blk in weights]
    x = _w(rng, 2, 200, C).to(cuda)
    _, amax = mrf.mrf_walk(x.transpose(1, 2), weights, kernel_sizes, dilations, lambda j, y: y.abs().amax())
    act = torch.stack(amax)
    assert (mrf.plan_fused("int8", C, kernel_sizes, dilations, False, 2, 200, 132) is None) == (C != 32)
    tw, _, _ = mrf.prepare_mrf_weights(weights, quantize_int8=True)
    kw = dict(quantize_int8=True, act_scales=act)
    got = mrf.fused_mrf(x, tw, kernel_sizes, dilations, **kw)
    want = mrf.fused_mrf_plain(x, tw, kernel_sizes, dilations, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _fused_case(rng, cuda, C, resblock2, route, B, L, kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3):
    """Weights in the route's layout, the float32 stage trunk x [B, L, C]
    and the twin's output for the fused kernel's comparisons: bf16-rounded
    operands (``bf16_dots``) for bf16, static int8 at the calibrated amax
    for int8."""
    weights, _, _ = _stage(rng, 0, C, 0, 1, False, resblock2, kernel_sizes, dilations)
    weights = [tuple(None if t is None else t.to(cuda) for t in blk) for blk in weights]
    x = _w(rng, B, L, C).to(cuda)
    kw = {}
    if route == "int8":
        _, amax = mrf.mrf_walk(x.transpose(1, 2), weights, kernel_sizes, dilations, lambda j, y: y.abs().amax())
        kw = dict(quantize_int8=True, act_scales=torch.stack(amax))
    tw, _, _ = mrf.prepare_mrf_weights(weights, compute_dtype=torch.bfloat16, quantize_int8=route == "int8")
    want = mrf.fused_mrf_plain(x, tw, kernel_sizes, dilations, bf16_dots=route == "bf16", **kw)
    return tw, x, kw.get("act_scales"), want


def _run_fused(route, x, tw, act, launch, kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3):
    """The fused kernel alone on the float32 trunk x with the given plan:
    the stage output in float32."""
    out = torch.empty_like(x)
    lib = _build.load_library()
    mrf._launch_fused(lib, _build.stream_ptr(x.device), route, x, tw, kernel_sizes, dilations, act,
                      launch, out, 0)
    torch.cuda.synchronize()
    return out


def _hold_fused(route, got, want):
    """K2 bf16: rel-RMS 1e-3 against the bf16-operand twin and 0.02 of the
    output scale; K3 static: bitwise (exact integer dots, the same float32
    steps in the same order)."""
    if route == "bf16":
        assert _rel_rms(got, want) <= 1e-3
        assert (got - want).abs().max().item() <= 0.02 * max(want.abs().max().item(), 1.0)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("route", ["bf16", "int8"])
@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("resblock2", [False, True], ids=["resblock1", "resblock2"])
@pytest.mark.parametrize("L", [5, 61, 203, 1001, 40448])
def test_fused_resblocks_match_the_twin(cuda, route, C, resblock2, L):
    """The fused pipeline at each width it takes on each route, as
    ``plan_fused`` plans it: L = 5 and 61 are shorter than the k = 11
    resblock's halo (60 rows), 203, 1001 and 40,448 (the lead request's
    last stage) are ragged against every tile, the last in windows of two
    TMA boxes."""
    rng = np.random.RandomState(C + L)
    tw, x, act, want = _fused_case(rng, cuda, C, resblock2, route, 2, L)
    launch = mrf.plan_fused(route, C, (3, 7, 11), ((1, 3, 5),) * 3, resblock2, 2, L,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    _hold_fused(route, _run_fused(route, x, tw, act, launch), want)


@pytest.mark.parametrize("route", ["bf16", "int8"])
@pytest.mark.parametrize("C", [32, 64])
def test_fused_resblocks_in_every_tile_shape(cuda, route, C):
    """Other plans than ``plan_fused``'s: the smallest tile (64 rows), the
    widest window, each ring depth the kernel takes that fits, and one CTA
    walking every tile, against the same twin."""
    rng = np.random.RandomState(7)
    ks, ds, L = (3, 7, 11), ((1, 3, 5),) * 3, 1300
    tw, x, act, want = _fused_case(rng, cuda, C, False, route, 2, L)
    p = mrf.plan_fused(route, C, ks, ds, False, 2, L, 132)
    tried = set()
    for stages in range(mrf.FUSED_MIN_STAGES, mrf.FUSED_MAX_STAGES + 1):
        wins = [w for w in mrf.fused_windows() if w - 2 * p.halo >= 64
                and mrf.fused_smem_bytes(route, C, w, w - 2 * p.halo, stages) <= mrf.SMEM_LIMIT]
        for win in {wins[0], wins[-1]} if wins else ():
            tiles = -(-L // (win - 2 * p.halo))
            ctas = 1 if win == wins[0] else 2 * tiles
            tried.add((win, stages))
            launch = p._replace(win=win, bm=win - 2 * p.halo, stages=stages, tiles_per_row=tiles, ctas=ctas)
            _hold_fused(route, _run_fused(route, x, tw, act, launch), want)
    assert len(tried) >= 4 and max(w for w, _ in tried) > 256


def test_fused_kernel_refuses_a_plan_that_does_not_fit(cuda):
    """A window that is not the tile plus twice the halo, one past the
    kernel's blocks, one past a TMA box that two boxes cannot split into
    aligned halves, or a ring too deep is refused by the C side: the
    wrapper raises."""
    rng = np.random.RandomState(8)
    tw, x, act, _ = _fused_case(rng, cuda, 32, False, "bf16", 1, 100)
    p = mrf.plan_fused("bf16", 32, (3, 7, 11), ((1, 3, 5),) * 3, False, 1, 100, 132)
    for bad in (p._replace(win=p.win + 8), p._replace(win=528, bm=528 - 2 * p.halo),
                p._replace(win=264, bm=264 - 2 * p.halo), p._replace(stages=5)):
        with pytest.raises(RuntimeError, match="fused_mrf bf16 resblocks: CUDA error"):
            _run_fused("bf16", x, tw, act, bad)


@pytest.mark.parametrize("route", ["bf16", "int8"])
@pytest.mark.parametrize("C", mrf.FUSED_CHANNELS)
def test_fused_stage_at_the_bulk_shape(cuda, route, C):
    """Each fused stage of the default generator at B = 64 and 768 mel
    frames (C = 64: 98,304 rows a batch row, C = 32: 196,608) through
    ``fused_mrf``, against the twin."""
    rng = np.random.RandomState(9)
    L = 768 * 64 * 128 // C
    tw, x, act, want = _fused_case(rng, cuda, C, False, route, 64, L)
    dtype = torch.bfloat16 if route == "bf16" else torch.float32
    kw = dict(quantize_int8=True, act_scales=act) if route == "int8" else {}
    got = mrf.fused_mrf(x.to(dtype), tw, (3, 7, 11), ((1, 3, 5),) * 3, compute_dtype=dtype, **kw)
    torch.cuda.synchronize()
    if route == "bf16":  # the stage output is stored in bf16: hold it to the twin's bf16 output
        want = mrf.fused_mrf_plain(x.to(dtype), tw, (3, 7, 11), ((1, 3, 5),) * 3, compute_dtype=dtype,
                                   bf16_dots=True).float()
    _hold_fused(route, got.float(), want)


# ---------------------------------------------------------------------------
# The per-conv wgmma pipeline (csrc/mrf_conv_wgmma.cuh): the C = 256 and 128
# stages on the bf16 and static int8 routes.
# ---------------------------------------------------------------------------

STAGE_ROWS = {256: 8, 128: 64}  # rows of the default stage of width C a mel frame
# (B, mel frames, rows): the lead's B=1 at 512 frames, B=2 at 128, the bulk
# B=64 at 768, and ragged rows shorter than a k = 11 conv's reach and past
# one tile; tests/test_torch_mrf_conv.py holds that these reach every tile
# shape of the plan
CONV_CASES = [(1, 512, None), (2, 128, None), (64, 768, None), (2, None, 5), (2, None, 1001), (1, None, 12800)]


def _run_conv(route, x, tw, act, kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3):
    """The stage's MRF convs on the per-conv wgmma pipeline alone, whatever
    the router would choose: the float32 stage output."""
    out = torch.empty_like(x)
    lib = _build.load_library()
    mrf._launch_conv_wgmma(lib, _build.stream_ptr(x.device), route, x, tw, kernel_sizes, dilations, act, out, 0)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("route", ["bf16", "int8"])
@pytest.mark.parametrize("C", [256, 128])
@pytest.mark.parametrize("B,frames,L", CONV_CASES)
def test_conv_wgmma_stage_matches_the_twin(cuda, route, C, B, frames, L):
    """Each stage the pipeline takes, at the lead's, the B=2 and the bulk
    shapes and at ragged lengths, held to K2's bars (0.02 of the output
    scale against the float32 twin, rel-RMS 1e-3 against the bf16-operand
    twin) and K3's (bitwise: the same codes, exact integer dots, the same
    float32 steps)."""
    L = L or frames * STAGE_ROWS[C]
    rng = np.random.RandomState(C + L + B)
    tw, x, act, want = _fused_case(rng, cuda, C, False, route, B, L)
    got = _run_conv(route, x, tw, act)
    if route == "bf16":
        f32 = mrf.fused_mrf_plain(x, tw, (3, 7, 11), ((1, 3, 5),) * 3)
        assert (got - f32).abs().max().item() <= 0.02 * max(f32.abs().max().item(), 1.0)
        assert _rel_rms(got, want) <= 1e-3
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("route", ["bf16", "int8"])
def test_conv_wgmma_resblock2_stage_matches_the_twin(cuda, route):
    """ResBlock2 (one dilated conv a unit, the operands alternating between
    two buffers) at C = 128."""
    rng = np.random.RandomState(11)
    tw, x, act, want = _fused_case(rng, cuda, 128, True, route, 2, 777)
    got = _run_conv(route, x, tw, act)
    _hold_fused(route, got, want)


def test_conv_wgmma_int8_conv_is_bitwise_and_flips_no_code(cuda):
    """One K3 conv: the stage input's codes from the operand pass equal the
    twin's (0 flips), the conv's float32 output is bitwise
    ``_conv_int8``'s, and the codes its epilogue writes for the next conv
    are the twin's codes of that output at the next scale."""
    rng = np.random.RandomState(12)
    B, L, C, k, dil = 2, 3001, 256, 11, 5
    x = _w(rng, B, L, C).to(cuda)
    w = _w(rng, 1, k, C, C, s=0.5 / (k * C) ** 0.5).to(cuda)
    b = _w(rng, 1, C, s=0.05).to(cuda)
    q = mrf.quantize_weight_int8(w)
    act = torch.stack([F.leaky_relu(x, 0.1).abs().amax(), torch.tensor(3.0, device=cuda)])
    lib, stream = _build.load_library(), _build.stream_ptr(cuda)
    codes = torch.empty(B, C // 16, L, 16, dtype=torch.int8, device=cuda)
    rows = (ctypes.c_longlong * 2)(codes.data_ptr(), act.data_ptr())
    _build.check(lib.viettts_mrf_conv_operands_int8(B, L, C, x.data_ptr(), 1, ctypes.addressof(rows), stream), "operands")
    want_codes = mrf.pack_operand(mrf.operand_of(x.transpose(1, 2), "int8", act[0]))
    torch.cuda.synchronize()
    assert int((codes != want_codes).sum()) == 0
    y = torch.empty(B, L, C, device=cuda)
    nxt = torch.empty_like(codes)
    table = [codes.data_ptr(), q.slots.data_ptr(), b.data_ptr(), q.scales.data_ptr(), act.data_ptr(),
             act.data_ptr() + 4, 0, y.data_ptr(), 0, nxt.data_ptr(), k, dil, 0]
    t = (ctypes.c_longlong * len(table))(*table)
    _build.check(lib.viettts_mrf_conv_wgmma_int8(0, B, L, C, 1.0, 1, ctypes.addressof(t), stream), "conv")
    torch.cuda.synchronize()
    want = mrf._conv_int8(F.leaky_relu(x.transpose(1, 2), 0.1), q.codes[0], q.scales[0], b[0], dil, act[0])
    torch.testing.assert_close(y, want.transpose(1, 2), rtol=0, atol=0)
    assert torch.equal(nxt, mrf.pack_operand(mrf.operand_of(want, "int8", act[1])))


def test_conv_wgmma_refuses_a_bad_table(cuda):
    """The C side refuses a width its plan does not tile (C = 64), a conv
    that accumulates without y, and an int8 conv without its scale: the
    wrapper raises."""
    lib, stream = _build.load_library(), _build.stream_ptr(cuda)
    x = torch.zeros(1, 16, 100, 8, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(1, 2, 3, 8, 128, 8, dtype=torch.bfloat16, device=cuda)
    bias = torch.zeros(128, device=cuda)
    good = [x.data_ptr(), w.data_ptr(), bias.data_ptr(), 0, 0, 0, 0, 0, 0, x.data_ptr(), 3, 1, 0]
    for fn, C, row in ((lib.viettts_mrf_conv_wgmma, 64, good), (lib.viettts_mrf_conv_wgmma, 128, good[:12] + [1]),
                       (lib.viettts_mrf_conv_wgmma_int8, 128, good)):
        t = (ctypes.c_longlong * 13)(*row)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(fn(0, 1, 100, C, 1.0, 1, ctypes.addressof(t), stream), "wgmma convs")


# ---------------------------------------------------------------------------
# The per-conv wgmma pipeline's float32 route (3xTF32) and dynamic-scale int8
# route, at C = 256, 128, 64 and 32.
# ---------------------------------------------------------------------------

STAGE_ROWS.update({64: 128, 32: 256})
NEW_ROUTES = ["tf32", "int8_dynamic"]


def _new_route_case(rng, cuda, C, resblock2, route, B, L):
    """Weights in the route's layout (float32 ``Tf32Conv``, or ``Int8Conv``
    without calibrated scales), the float32 stage trunk x [B, L, C] and the
    float32 twin's output: the float32 route, or dynamic int8."""
    weights, _, _ = _stage(rng, 0, C, 0, 1, False, resblock2, (3, 7, 11), ((1, 3, 5),) * 3)
    weights = [tuple(None if t is None else t.to(cuda) for t in blk) for blk in weights]
    x = _w(rng, B, L, C).to(cuda)
    tw, _, _ = mrf.prepare_mrf_weights(weights, quantize_int8=route == "int8_dynamic")
    want = mrf.fused_mrf_plain(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, quantize_int8=route == "int8_dynamic",
                               tiles=False)
    return tw, x, want


def _hold_new_route(route, got, want):
    """K2 float32: rtol 1e-5 + atol 1e-4 (3xTF32 keeps 22 of 24 bits a
    part; the sums' order differs); K3 dynamic: bitwise."""
    if route == "tf32":
        assert bool(((got - want).abs() <= 1e-4 + 1e-5 * want.abs()).all()), (got - want).abs().max().item()
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("route", NEW_ROUTES)
@pytest.mark.parametrize("C", [256, 128, 64, 32])
@pytest.mark.parametrize("resblock2", [False, True], ids=["resblock1", "resblock2"])
@pytest.mark.parametrize("B,frames", [(1, 512), (2, 128)])
def test_conv_wgmma_new_route_matches_the_twin(cuda, route, C, resblock2, B, frames):
    """The float32 route and dynamic int8 on the per-conv wgmma pipeline, at
    each width and the lead's B=1 (512 frames) and B=2 (128 frames)
    shapes, whatever the router would choose, against the float32 twin
    and the dynamic int8 twin of one run (one amax a batch row)."""
    L = frames * STAGE_ROWS[C]
    rng = np.random.RandomState(C + L + B + resblock2)
    tw, x, want = _new_route_case(rng, cuda, C, resblock2, route, B, L)
    _hold_new_route(route, _run_conv(route, x, tw, None), want)


@pytest.mark.parametrize("route", NEW_ROUTES)
@pytest.mark.parametrize("C", [256, 32])
@pytest.mark.parametrize("L", [5, 1001])
def test_conv_wgmma_new_route_at_ragged_lengths(cuda, route, C, L):
    """L shorter than a k = 11 conv's reach and past one tile."""
    rng = np.random.RandomState(C + L)
    tw, x, want = _new_route_case(rng, cuda, C, False, route, 2, L)
    _hold_new_route(route, _run_conv(route, x, tw, None), want)


@pytest.mark.parametrize("route", NEW_ROUTES)
@pytest.mark.parametrize("C", [256, 128, 64, 32])
def test_new_route_stage_is_routed_counted_and_capturable(cuda, route, C):
    """Through ``fused_mrf`` at B=1 x 512 frames: a width the router gives
    the pipeline counts one stage on its counter and none on
    ``mma_conv_kernel``'s routes (dynamic int8: one run of the TPU kernel's
    tile windows, 4 at C <= 128, against the tile-aware twin); a CUDA graph of the call replays it (the dynamic
    route's amax memset and passes included)
    with the same output, bitwise, and the same count a replay."""
    B, L = 1, 512 * STAGE_ROWS[C]
    rng = np.random.RandomState(C)
    tw, x, want = _new_route_case(rng, cuda, C, False, route, B, L)
    kw = dict(quantize_int8=True) if route == "int8_dynamic" else {}
    runs = [(B, L)]
    if route == "int8_dynamic":
        want = mrf.fused_mrf_plain(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)
        run = mrf.dynamic_windows(x, tw, (3, 7, 11), ((1, 3, 5),) * 3)
        assert (run is None) == (C == 256)
        if run is not None:  # one run of every window, or a run for each length on copies
            runs = [(B * run.n, run.length)] if mrf.conv_takes(route, B * run.n, run.length, C) else \
                [(B * len(items), n) for n, items in mrf.tile_windows(run.seq, run.tile, run.halo)]
    counter = mrf.CONV_COUNTERS[route]
    before = getattr(mrf.fused_mrf, counter)
    got = mrf.fused_mrf(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)
    routed = sum(mrf.conv_takes(route, b, n, C) for b, n in runs)
    assert getattr(mrf.fused_mrf, counter) - before == routed
    _hold_new_route(route, got, want)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        mrf.fused_mrf(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)  # warm: opt-ins, plans
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            out = mrf.fused_mrf(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, got, rtol=0, atol=0)


def test_conv_wgmma_dynamic_conv_is_bitwise_and_flips_no_code(cuda):
    """One dynamic K3 conv through the stage entry: the amax of the stage
    input (row 0) is the twin's row amax, its codes flip none, the conv's
    float32 output is bitwise ``_conv_int8``'s with that amax, its folded
    amax (row 1) is the row amax of lrelu(output), and the quantize pass's
    codes are the twin's codes of the output at it."""
    rng = np.random.RandomState(13)
    B, L, C, k, dil = 2, 3001, 256, 11, 5
    x = _w(rng, B, L, C).to(cuda)
    w = _w(rng, 1, k, C, C, s=0.5 / (k * C) ** 0.5).to(cuda)
    b = _w(rng, 1, C, s=0.05).to(cuda)
    q = mrf.quantize_weight_int8(w)
    lib, stream = _build.load_library(), _build.stream_ptr(cuda)
    codes = torch.empty(B, C // 16, L, 16, dtype=torch.int8, device=cuda)
    amax = torch.full((2, B), 7.0, device=cuda)  # the entry zeroes it
    y = torch.empty(B, L, C, device=cuda)
    nxt = torch.empty_like(codes)
    table = [codes.data_ptr(), q.slots.data_ptr(), b.data_ptr(), q.scales.data_ptr(), amax.data_ptr(),
             amax.data_ptr() + 4 * B, 0, y.data_ptr(), 0, nxt.data_ptr(), k, dil, 0]
    t = (ctypes.c_longlong * len(table))(*table)
    _build.check(lib.viettts_mrf_conv_wgmma_int8_dynamic(0, B, L, C, 1.0, 1, ctypes.addressof(t), x.data_ptr(),
                                                         codes.data_ptr(), amax.data_ptr(), 2, 0, 0, 0, 0, 0, 0,
                                                         stream), "conv")
    torch.cuda.synchronize()
    xin = F.leaky_relu(x.transpose(1, 2), 0.1)
    assert torch.equal(amax[0], mrf.row_amax(xin))
    assert int((codes != mrf.pack_operand(mrf.operand_of(x.transpose(1, 2), "int8_dynamic"))).sum()) == 0
    want = mrf._conv_int8(xin, q.codes[0], q.scales[0], b[0], dil, None)
    torch.testing.assert_close(y, want.transpose(1, 2), rtol=0, atol=0)
    assert torch.equal(amax[1], mrf.row_amax(F.leaky_relu(want, 0.1)))
    assert torch.equal(nxt, mrf.pack_operand(mrf.operand_of(want, "int8_dynamic")))


# Dynamic int8 on the TPU kernel's tile windows: one amax a window of a
# tile and its halo (JAX's default geometry: 8,192 packed rows a tile at
# C <= 128; ``mrf.dynamic_windows``).
@pytest.mark.parametrize("wgmma", [True, False], ids=["one_run", "copies"])
@pytest.mark.parametrize("B,frames,C,tiles", [(1, 256, 32, 2), (2, 512, 128, 4)])
def test_dynamic_stage_on_tile_windows_is_the_twin(cuda, B, frames, C, tiles, wgmma, monkeypatch):
    """The dynamic K3 stage (bf16 storage, no prologue: the same float32
    input on both sides) through ``fused_mrf`` against the tile-aware twin,
    bitwise: on the wgmma pipeline one run of every window on the full
    trunk (zero outside the sequence, every window's tile written in
    place), on ``mma_conv_kernel`` (``mrf.CONV_WGMMA`` off) a run for each
    length of window on copies, each the per-row pipeline's function."""
    monkeypatch.setattr(mrf, "CONV_WGMMA", wgmma)
    L = frames * {32: 256, 128: 64}[C]
    rng = np.random.RandomState(C + B)
    weights, _, _ = _stage(rng, 0, C, 0, 1, False, False, (3, 7, 11), ((1, 3, 5),) * 3)
    weights = [tuple(t.to(cuda) for t in blk) for blk in weights]
    tw, _, _ = mrf.prepare_mrf_weights(weights, compute_dtype=torch.bfloat16, quantize_int8=True)
    x = _w(rng, B, L, C).to(cuda, torch.bfloat16)
    kw = dict(compute_dtype=torch.bfloat16, quantize_int8=True)
    run = mrf.dynamic_windows(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, store=torch.bfloat16)
    assert run is not None and run.n == tiles
    got = mrf.fused_mrf(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)
    want = mrf.fused_mrf_plain(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    rows = mrf.fused_mrf_plain(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, tiles=False, **kw)
    assert not torch.equal(got, rows)  # one amax a batch row is another function


def test_dynamic_stage_with_prologue_and_post_on_tile_windows(cuda):
    """The last default stage whole (the FP64 prologue and conv_post) at
    B=1, 256 frames (2 tiles) against the tile-aware twin, at K3's bars:
    the prologue's float64 sums and the epilogue's float32 sums run in
    another order, so only a code at a rounding boundary can flip."""
    rng = np.random.RandomState(17)
    weights, ups, pst = _stage(rng, 64, 32, 4, 2, True, False, (3, 7, 11), ((1, 3, 5),) * 3)
    weights = [tuple(t.to(cuda) for t in blk) for blk in weights]
    ups = (ups[0].to(cuda), ups[1].to(cuda), 2)
    pst = (pst[0].to(cuda), pst[1].to(cuda))
    tw, tu, tp = mrf.prepare_mrf_weights(weights, ups, pst, torch.bfloat16, quantize_int8=True)
    x = _w(rng, 1, 256 * 128, 64).to(cuda, torch.bfloat16)
    kw = dict(upsample=tu, post=tp, compute_dtype=torch.bfloat16, quantize_int8=True)
    assert mrf.dynamic_windows(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, tu, tp, torch.bfloat16).n == 2
    got = mrf.fused_mrf(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)
    want = mrf.fused_mrf_plain(x, tw, (3, 7, 11), ((1, 3, 5),) * 3, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (1, 256 * 256, 1)
    assert (got - want).abs().max().item() <= 0.02 * max(want.abs().max().item(), 1.0)
    assert _rel_rms(got, want) <= 1e-3


def test_odd_frames_leave_stage_0_unquantized(cuda):
    """At 127 mel frames the TPU kernel refuses stage 0's tile (1,016 rows,
    not 16-row aligned) and JAX's generator runs that stage as XLA convs in
    bf16: the port runs it as ``xla_stage`` (plain torch, float64 sums),
    with no K2 or K3 launch, bit for bit its output on the CPU; stages 1-3
    run on K3."""
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.models import hifigan

    torch.manual_seed(0)
    cfg = Config().hifigan
    gen = hifigan.Generator(cfg).to(cuda).eval()
    mel = torch.randn(1, 127, 80, device=cuda)
    stages, xla = [], []
    real, real_xla = hifigan.fused_mrf, hifigan.xla_stage

    def counts():
        return mrf.fused_mrf.launches, mrf.fused_mrf.int8_launches

    def spy(*args, **kwargs):
        before = counts()
        out = real(*args, **kwargs)
        stages.append((kwargs["quantize_int8"], counts()[0] - before[0], counts()[1] - before[1]))
        return out

    def xla_spy(x, *args, **kwargs):
        before = counts()
        out = real_xla(x, *args, **kwargs)
        xla.append((x, out, counts()[0] - before[0], counts()[1] - before[1]))
        return out

    hifigan.fused_mrf, hifigan.xla_stage = spy, xla_spy
    try:
        with torch.no_grad():
            wave = hifigan.generator_apply_fused(gen, mel, torch.bfloat16, quantize_int8=True)
    finally:
        hifigan.fused_mrf, hifigan.xla_stage = real, real_xla
    torch.cuda.synchronize()
    assert stages == [(True, 1, 1)] * 3
    assert [launches[2:] for launches in xla] == [(0, 0)]
    assert wave.shape == (1, 127 * 256, 1) and bool(torch.isfinite(wave).all())
    x, out = xla[0][:2]
    cpu = hifigan.Generator(cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()})
    with torch.no_grad():
        want = real_xla(x.cpu(), *cpu.fused_weights(torch.bfloat16)[0], cfg.resblock_kernel_sizes,
                        cfg.resblock_dilation_sizes, torch.bfloat16)
    assert out.shape == (1, 127 * 8, 256) and torch.equal(out.cpu(), want)


def test_conv_wgmma_tf32_operands_are_the_split(cuda):
    """The float32 route's stage operand pass writes lrelu(h)'s TF32 parts
    hi and lo chunk-major, bit for bit the host's split (``tf32_parts``)."""
    rng = np.random.RandomState(14)
    B, L, C = 2, 777, 64
    x = _w(rng, B, L, C).to(cuda)
    lib, stream = _build.load_library(), _build.stream_ptr(cuda)
    op = torch.empty(B, C // 2, L, 4, device=cuda)
    rows = (ctypes.c_longlong * 2)(op.data_ptr(), 0)
    _build.check(lib.viettts_mrf_conv_operands_tf32(B, L, C, x.data_ptr(), 1, ctypes.addressof(rows), stream), "op")
    torch.cuda.synchronize()
    want = mrf.pack_operand(mrf.operand_of(x.transpose(1, 2), "tf32"))
    assert torch.equal(op.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# The training slice on the card against the CPU (no kernel of the port:
# eager PyTorch, TF32 off for matmuls and cuDNN convs).
# ---------------------------------------------------------------------------


def test_training_step_on_card_matches_cpu(cuda):
    """One step of each trainer at a small config, on the card and on the
    CPU (``chip_smoke.train_card_vs_cpu``): loss, parameters and batch
    statistics within 1e-4 of each leaf's largest value."""
    import chip_smoke

    errs = chip_smoke.train_card_vs_cpu()
    assert sorted(errs) == ["acoustic", "duration"] and max(errs.values()) <= chip_smoke.TRAIN_REL


def test_gan_step_on_card_matches_cpu(cuda):
    """One HiFi-GAN step (discriminator then generator step) at a small
    config, on the card and on the CPU (``chip_smoke.gan_card_vs_cpu``):
    every loss and the new spectral ``u`` within 1e-4."""
    import chip_smoke

    errs = chip_smoke.gan_card_vs_cpu()
    assert sorted(errs) == ["adv", "disc_loss", "fm", "gen_loss", "mel_l1", "u"]
    assert max(errs.values()) <= chip_smoke.GAN_REL


def test_log_mel_on_card_matches_cpu(cuda):
    from viettts_tpu_torch.config import DspConfig
    from viettts_tpu_torch.ops.mel import LogMelSpectrogram

    rng = np.random.RandomState(2)
    y = torch.from_numpy((rng.randn(3, 256 * 50) * 0.3).astype(np.float32))
    y[2, 6000:] = 0
    fn = LogMelSpectrogram(DspConfig())
    want = fn(y)
    got = fn.to(cuda)(y.to(cuda)).cpu()
    assert got.shape == want.shape == (3, 50, 80)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The multi-device layer on one card: a one-rank NCCL group, two serving
# replicas on cuda:0.
# ---------------------------------------------------------------------------


def test_one_rank_nccl_update_matches_plain(cuda, tmp_path):
    """One update of the duration and acoustic trainers at a small config
    under a one-rank NCCL group (``data_parallel=True``) against no group,
    deterministic algorithms on (``chip_smoke.nccl_step_vs_plain``): loss
    and parameters within 1e-6 of each leaf's largest value."""
    import chip_smoke

    errs = chip_smoke.nccl_step_vs_plain(tmp_path / "store")
    assert sorted(errs) == ["acoustic", "duration"] and max(errs.values()) <= chip_smoke.NCCL_REL


def test_two_replicas_on_one_card_match_one_device(cuda, tmp_path):
    """``Synthesizer(devices=["cuda:0", "cuda:0"])`` at the default width on
    seeded weights, float32 route (``chip_smoke.replicated_serving``):
    mels and waves within 1e-4 of one device; K1 and K2 launch for both
    replicas (warmup's two frame buckets and one batch: 6 decodes, 6
    vocoders of 4 stages) and for the lead program that warmup captures on
    the first device (its eager run and one replay: 2 decodes, 2
    vocoders), no plain twin."""
    import chip_smoke
    from viettts_tpu_torch.config import Config

    cfg = Config()
    chip_smoke.write_checkpoints(cfg, tmp_path)
    dec, voc = ar_decoder.ar_decode, mrf.fused_mrf

    def zero():
        dec.launches = dec.plain_calls = voc.launches = voc.plain_calls = 0

    out, counts = chip_smoke.replicated_serving(
        cfg, tmp_path, routes=("float32",), zero=zero,
        read=lambda: (dec.launches, dec.plain_calls, voc.launches, voc.plain_calls))
    assert counts == (8, 0, 32, 0)
    assert out["float32"]["mel_max_abs"] <= 1e-4 and out["float32"]["wave_max_abs"] <= 1e-4


# ---------------------------------------------------------------------------
# The single-dispatch lead program as a CUDA graph.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def default_ckpts(tmp_path_factory):
    import chip_smoke
    from viettts_tpu_torch.config import Config

    d = tmp_path_factory.mktemp("lead_ckpts")
    if torch.cuda.is_available():
        chip_smoke.write_checkpoints(Config(), d)
    return d


def _synth(ckpt_dir, *flags):
    from viettts_tpu_torch.config import Config, apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    return Synthesizer(apply_overrides(Config().replace(ckpt_dir=ckpt_dir), list(flags)), device="cuda")


@pytest.mark.parametrize("route", ["float32", "bfloat16", "int8"])
def test_lead_graph_replay_matches_the_eager_program(cuda, default_ckpts, route):
    """At the default width on each route: the captured graph of a bucket
    replays the eager lead program within the route's card bar
    (``chip_smoke.lead_replay_vs_eager``), and two replays are bitwise
    equal; warmup captures one graph per token bucket of at most 64."""
    import chip_smoke

    synth = _synth(default_ckpts, f"hifigan.inference_dtype={route}")
    synth.warmup(token_buckets=(32, 64, 128))
    assert sorted(synth.lead_graphs) == [32, 64]
    errs = chip_smoke.lead_replay_vs_eager(synth)
    assert errs["bitwise_replays"] and errs["bucket"] == 64


@pytest.mark.parametrize("route", ["bfloat16", "int8"])
def test_lead_replays_are_counted(cuda, default_ckpts, route):
    """Each replay adds the launches its capture recorded (two bi-LSTMs,
    one K1, four vocoder stages; K3's on the int8 route), the capture
    itself none, and no plain twin runs."""
    dec, voc, lstm = ar_decoder.ar_decode, mrf.fused_mrf, rnn.bidirectional_lstm
    synth = _synth(default_ckpts, f"hifigan.inference_dtype={route}")
    synth.calibrate_int8()
    text = "xin chào các bạn"
    synth.synthesize(text)  # the bucket's eager run, capture and first replay
    dec.launches = dec.plain_calls = voc.launches = voc.int8_launches = voc.plain_calls = 0
    lstm.launches = lstm.plain_calls = 0
    for _ in range(3):
        synth.synthesize(text)
    int8 = route == "int8"
    assert (lstm.launches, lstm.plain_calls, dec.launches, dec.plain_calls, voc.launches, voc.int8_launches,
            voc.plain_calls) == (6, 0, 3, 0, 12, 12 if int8 else 0, 0)


def test_bulk_dispatch_counts_two_lstm_launches(cuda, default_ckpts):
    """After warm-up a bucketed call of 64 rows runs each encoder's bi-LSTM
    as one kernel launch (the duration model's, the acoustic model's) and
    never the loop."""
    lstm = rnn.bidirectional_lstm
    synth = _synth(default_ckpts, "hifigan.inference_dtype=bfloat16")
    words = "xin chào các bạn hôm nay trời đẹp quá một hai ba bốn năm sáu bảy".split()
    texts = [" ".join(words[: 3 + i % 12]) for i in range(64)]
    synth.synthesize_batch(texts)
    lstm.launches = lstm.plain_calls = 0
    results = synth.synthesize_batch(texts)
    assert len(results) == 64 and (lstm.launches, lstm.plain_calls) == (2, 0)


def test_bucketed_dispatch_snaps_to_a_warmed_bucket(cuda, default_ckpts):
    """F6 on the card (``chip_smoke.snap_check``): after ``warmup``, a
    bucketed row of natural bucket 384 decodes the warmed 512, and one no
    warmed bucket holds within 2x decodes its own 640."""
    import chip_smoke
    from viettts_tpu_torch.config import Config

    out = chip_smoke.snap_check(Config(), default_ckpts)
    assert out["300_frames"]["decoded"] == [512] and out["600_frames"]["decoded"] == [640]


def test_lead_matches_bucketed_and_overflow_falls_back(cuda, default_ckpts):
    """float32, durations pinned: the replay against the bucketed path on
    the kept audio (1e-4), and the overflow's fallback
    (``chip_smoke.lead_vs_bucketed``)."""
    import chip_smoke
    from viettts_tpu_torch.config import Config

    errs = chip_smoke.lead_vs_bucketed(Config(), default_ckpts)
    assert errs["wave_max_abs"] <= chip_smoke.LEAD_ATOL


def test_lead_graph_under_concurrent_callers(cuda, default_ckpts):
    """Threads sharing one Synthesizer (more threads than the machine has
    cores, a short switch interval): the first use of a bucket captures
    its graph while others wait on the lock, and every result equals the
    same text's result from one thread, bitwise (a replay's outputs are
    copied out before the next replay overwrites them)."""
    import os
    import sys
    import threading

    texts = ["xin chào các bạn", "hôm nay trời đẹp quá", "một hai ba bốn năm"]
    synth = _synth(default_ckpts, "hifigan.inference_dtype=bfloat16", "acoustic.prenet_dropout_at_inference=false")
    got, errors = [], []

    def worker(i):
        try:
            for j in range(3):
                text = texts[(i + j) % len(texts)]
                got.append((text, synth.synthesize(text).wave))
        except Exception as e:  # reported below, with the thread's result missing
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2 * (os.cpu_count() or 4))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert sorted(synth.lead_graphs) == [32] and len(got) == 3 * len(threads)
    want = {text: synth.synthesize(text).wave for text in texts}
    for text, wave in got:
        np.testing.assert_array_equal(wave, want[text])


def test_calibrate_int8_drops_the_int8_graphs(cuda, default_ckpts):
    """New int8 scales are not what a captured graph reads: ``calibrate_int8``
    drops the graphs, and a graph captured under other scales is replaced
    at its next use."""
    synth = _synth(default_ckpts, "hifigan.inference_dtype=int8")
    synth.synthesize("xin chào")
    assert list(synth.lead_graphs) == [32] and synth.lead_graphs[32].act_scales is None
    synth.calibrate_int8()
    assert synth.lead_graphs == {}
    synth.synthesize("xin chào")
    assert synth.lead_graphs[32].act_scales is synth._act_scales
    synth._act_scales = {i: s * 1.5 for i, s in synth._act_scales.items()}
    synth.synthesize("xin chào")
    assert synth.lead_graphs[32].act_scales is synth._act_scales


# ---------------------------------------------------------------------------
# FLOP accounting and the int8 validation tools on the card.
# ---------------------------------------------------------------------------


def test_device_peaks_of_this_card(cuda):
    """``utils.flops.device_peaks`` knows the card it runs on, and the SM
    count it counts tiles with is the card's."""
    from viettts_tpu_torch.utils import flops

    peaks = flops.device_peaks()
    assert peaks == flops.peaks_for_name(torch.cuda.get_device_name(0))
    assert peaks.sm_count == torch.cuda.get_device_properties(0).multi_processor_count
    assert 0 < peaks.fp32 < peaks.tf32 < peaks.bf16 < peaks.int8 and peaks.hbm_bytes_per_s > 1e12


def test_validate_int8_clip_runs_k3_beside_its_simulation(cuda, tmp_path):
    """One clip of ``tools.validate_int8`` at the default width on seeded
    weights (``chip_smoke.write_checkpoints``): the static and dynamic int8
    routes launch K3 (4 stages each, no plain twin), while the diagnosis's
    full simulation (``tools.diagnose_int8.generator_walk``, plain torch)
    runs on the same card; K3's error against float32 lies within the
    tool's fault bar of the simulation's (0.25 of it + the bf16 route's
    error + 1e-3)."""
    import chip_smoke
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.ops.mel import LogMelSpectrogram
    from viettts_tpu_torch.tools import diagnose_int8, validate_int8
    from viettts_tpu_torch.tools.synth_corpus import heldout_clip

    cfg = Config()
    chip_smoke.write_checkpoints(cfg, tmp_path)
    gen = validate_int8.load_trained_generator(tmp_path / "hifigan_latest_ckpt.pickle", cfg, cuda)
    mel_fn = LogMelSpectrogram(cfg.dsp).to(cuda)
    with torch.no_grad():
        mel = mel_fn(torch.from_numpy(heldout_clip()[: 256 * 60]).to(cuda)[None])
    record = []
    with validate_int8.float32_convs():
        diagnose_int8.generator_walk(gen, mel, record=record)
        calib = diagnose_int8.calibration(record, 1.25)
        ref = diagnose_int8.generator_walk(gen, mel)
        sim = diagnose_int8.generator_walk(gen, mel, quant_w=True, act_mode="per_conv", calib=calib)
    assert sim.device.type == "cuda" and torch.isfinite(sim).all()
    voc = mrf.fused_mrf
    int8_launches, plain = voc.int8_launches, voc.plain_calls
    waves = validate_int8.route_waves(gen, mel, diagnose_int8.stage_scales(gen, calib))
    torch.cuda.synchronize()
    assert (voc.int8_launches - int8_launches, voc.plain_calls - plain) == (8, 0)
    metrics = validate_int8.clip_metrics("heldout", waves, mel_fn, 0.0)
    assert all(np.isfinite(v) for k, v in metrics.items() if k != "clip")
    simulated = diagnose_int8.rel_rms(sim.cpu(), ref.cpu())
    measured = metrics["rel_rms_vs_f32"]
    assert abs(measured - simulated) <= 0.25 * simulated + metrics["bf16_rel_rms_vs_f32"] + 1e-3
