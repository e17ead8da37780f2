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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_dots_twin_rounds_operands(dtype):
    """``bf16_dots`` rounds each MRF conv's lrelu input to bf16, the TPU
    kernel's DEFAULT-precision dot: it moves the output, by less than the
    bf16 bar (0.02 of the output scale)."""
    x, weights, ups, pst = _case(11, 2, 32, 32, 16, (16, 8), False)
    tw, tu, tp = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), None, dtype
    )
    xt = torch.from_numpy(x).to(dtype)
    kw = dict(upsample=tu, compute_dtype=dtype)
    ref = mrf.fused_mrf_plain(xt, tw, KERNEL_SIZES, DILATIONS, **kw).float()
    got = mrf.fused_mrf_plain(xt, tw, KERNEL_SIZES, DILATIONS, bf16_dots=True, **kw).float()
    diff = (got - ref).abs().max().item()
    assert 0 < diff <= 0.02 * max(ref.abs().max().item(), 1.0)


def test_tf32_split_is_rna_and_nearly_exact():
    """``tf32_round`` is PTX ``cvt.rna.tf32.f32`` (ties away from zero, low
    13 bits cleared); ``hi + lo`` of ``tf32_split`` keeps w to 2**-21, in
    the kernel's (O, I) tap layout."""
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    t = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp, 0.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0])
    assert torch.equal(mrf.tf32_round(t), want)
    rng = np.random.RandomState(12)
    w = torch.from_numpy((rng.randn(3, 7, 16, 16) * 0.1).astype(np.float32))
    split = mrf.tf32_split(w)
    assert split.shape == (3, 2, 7, 16, 16)
    assert int((split.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    split = split.transpose(-1, -2)  # the kernel's (O, I) taps back to (I, O)
    err = (split[:, 0].double() + split[:, 1].double() - w.double()).abs()
    assert bool((err <= w.double().abs() * 2.0 ** -21).all())
    assert (split[:, 1] != 0).any()


def test_float32_weights_carry_the_tf32_split():
    x, weights, _, _ = _case(5, 1, 32, 8, 8, None, False)
    tw, _, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy))
    w1 = tw[0][0]
    assert isinstance(w1, mrf.Tf32Conv)
    torch.testing.assert_close(w1.w, torch.from_numpy(weights[0][0]), rtol=0, atol=0)
    torch.testing.assert_close(w1.split, mrf.tf32_split(w1.w), rtol=0, atol=0)
    bad = [(mrf.Tf32Conv(w1.w, w1.split[:, :1]),) + tuple(tw[0][1:])] + list(tw[1:])
    with pytest.raises(ValueError, match="TF32 split"):
        mrf.fused_mrf(torch.from_numpy(x), bad, KERNEL_SIZES, DILATIONS)


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


class _DeviceRecorder:
    """Stands in for ``torch.cuda.device``: records the device each wrapper
    enters and which library calls ran while it was entered."""

    def __init__(self):
        self.entered, self.current, self.calls = [], None, []

    def __call__(self, device):
        recorder = self

        class Ctx:
            def __enter__(self):
                recorder.entered.append(device)
                recorder.current = device

            def __exit__(self, *exc):
                recorder.current = None

        return Ctx()

    def library(self):
        recorder = self

        class Lib:
            def __getattr__(self, name):
                def call(*args):
                    recorder.calls.append((name, recorder.current))
                    return 0

                return call

        return Lib()


def test_fused_mrf_launches_under_the_inputs_device(monkeypatch):
    """The stage wrapper runs every library call with its input's device
    current (the library launches on the current device and keeps its
    shared-memory opt-ins and SM counts per device).  On the CPU the
    library is a recorder and the input a CPU tensor: the wrapper must
    enter exactly ``x.device``."""
    rec = _DeviceRecorder()
    monkeypatch.setattr(torch.cuda, "device", rec)
    monkeypatch.setattr(mrf._build, "load_library", rec.library)
    monkeypatch.setattr(mrf._build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(mrf.fused_mrf, "launches", 0)
    x, weights, ups, pst = _case(5, 1, 16, 8, 4, (4, 2), True)
    tw, tu, tp = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), _to(pst, torch.from_numpy),
        compute_dtype=torch.bfloat16,
    )
    xb = torch.from_numpy(x).to(torch.bfloat16)
    mrf._fused_mrf_cuda(xb, tw, KERNEL_SIZES, DILATIONS, tu, tp, torch.bfloat16, 32, 4, False, None)
    assert rec.entered == [xb.device]
    names = [name for name, _ in rec.calls]
    assert names == ["viettts_mrf_to_f32", "viettts_mrf_convt_mma", "viettts_mrf_conv_plan", "viettts_mrf_post"]
    assert all(device == xb.device for _, device in rec.calls)


def test_convt_f64_launches_under_the_inputs_device(monkeypatch):
    """The int8 route's prologue wrapper enters its input's device: an
    input that claims to live on ``cuda:1`` (a stand-in; allocations go to
    the CPU) gets its launch with ``cuda:1`` current."""
    rec = _DeviceRecorder()
    monkeypatch.setattr(torch.cuda, "device", rec)
    monkeypatch.setattr(mrf._build, "load_library", rec.library)
    monkeypatch.setattr(mrf._build, "stream_ptr", lambda device: 0)
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *shape, device=None, **kw: real_empty(*shape, **kw))
    dev = torch.device("cuda", 1)

    class OnCard:
        dtype, device, shape = torch.float32, dev, (2, 5, 3)

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 0

    w = torch.zeros(4, 3, 6)
    h = mrf.convt_f64(OnCard(), mrf.F64Conv(w, w.double()), torch.zeros(6), 2)
    assert h.shape == (2, 10, 6)
    assert rec.entered == [dev] and rec.calls == [("viettts_mrf_convt_f64", dev)]
