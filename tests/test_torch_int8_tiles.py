"""The int8 vocoder route where the TPU kernel's tile geometry shows: the
dynamic scale a tile window, and the stages JAX's generator leaves
unquantized because the kernel refuses their geometry.

JAX's dynamic int8 scale is the amax of a conv input over one tile window
of the TPU kernel (``Tp`` packed rows and a halo of ``Hp`` on each side,
``viettts_tpu/ops/mrf.py:296-303``).  ``VIETTTS_MRF_TILE_MB=0``, JAX's own
tile knob, gives 256-row tiles, so that small inputs span several.  Bars
against JAX: rel-RMS 5e-3 and max abs 0.02 of max(|ref|, 1), the int8 bars
of ``tests/test_torch_int8.py``; the bf16 route's 0.02 max abs
(``tests/test_torch_models.py``) where JAX runs plain bf16 convs.

Where the kernel refuses a stage's tile geometry, JAX's generator catches
the ``ValueError`` and runs that stage on XLA instead
(``viettts_tpu/models/hifigan.py:763-822``): the ConvTranspose on XLA and
the fused MRF, or, where that call refuses too, plain convs in the compute
dtype, unquantized (the port's ``xla_stage``).  On the tiny config every
stage refuses at 17 and 41 mel frames, stage 0 alone at 20 (ResBlock1)
and 40 (ResBlock2).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import viettts_tpu.ops.mrf as jax_mrf
from viettts_tpu.models.hifigan import generator_apply_fused as jax_apply_fused
from viettts_tpu_torch.models import hifigan
from viettts_tpu_torch.ops import mrf
from tests.test_torch_int8 import _assert_int8_close, _rel_rms
from tests.test_torch_models import _generator, _hifigan_cfg
from tests.test_torch_mrf import DILATIONS, KERNEL_SIZES, _case, _to

JAX_PACK_TRANSPOSE = jax_mrf._pack_transpose_matrices

# C = 16 packs g = 8 steps a row: a 256-row tile is 2,048 steps
TILE_STEPS = 2048
STAGE_CASES = {
    # name: (B, C_in, (k_up, u) or None, post, resblock2); L_in steps a tile
    "mrf": (1, 16, None, False, False),
    "prologue_16_8": (1, 32, (16, 8), False, False),
    "conv_post": (1, 16, None, True, False),
    "resblock2": (1, 16, None, False, True),
    "batch_2": (2, 16, None, False, False),
}


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setenv("VIETTTS_MRF_TILE_MB", "0")


def _pack_matrices(w, k, d, g, C, C_out=None):
    """``viettts_tpu/ops/mrf.py::_pack_matrices`` in numpy: each block of a
    packed matrix takes one tap (an output block reads each input block
    through one tap at most), so adding into zeros gives JAX's bits."""
    C_out = C if C_out is None else C_out
    offsets, placements = jax_mrf._pack_offsets(k, d, g)
    index = {q: i for i, q in enumerate(offsets)}
    w = np.asarray(w).astype(np.float32)
    A = np.zeros((len(offsets), g * C, g * C_out), np.float32)
    for q, t, r, j in placements:
        A[index[q], r * C:(r + 1) * C, j * C_out:(j + 1) * C_out] += w[t]
    return offsets, jnp.asarray(A)


def _pack_transpose_matrices(w, bias, u, g_in, g_out):
    """``_pack_transpose_matrices`` in numpy, one tap a block as above."""
    k, C_in, C_out = w.shape
    F = (g_in * u) // g_out
    pad_a = mrf.convt_lead_pad(k, u)
    placements = []
    for r in range(g_in):
        for t in range(k):
            qp, j = divmod(r * u + pad_a - t, g_out)
            oq, f = divmod(qp, F)
            placements.append((-oq, t, r, f, j))
    offsets = sorted({p[0] for p in placements})
    index = {o: i for i, o in enumerate(offsets)}
    w = np.asarray(w).astype(np.float32)
    B = np.zeros((len(offsets), g_in * C_in, F * g_out * C_out), np.float32)
    for o, t, r, f, j in placements:
        col = (f * g_out + j) * C_out
        B[index[o], r * C_in:(r + 1) * C_in, col:col + C_out] += w[t]
    return offsets, jnp.asarray(B), jnp.tile(jnp.asarray(bias).astype(jnp.float32), F * g_out), F


@pytest.fixture(autouse=True)
def numpy_packing(monkeypatch):
    """JAX's packing as thousands of eager ``.at[].add`` calls costs most
    of a reference call at these narrow widths (g up to 64 steps a row);
    the numpy copies give the same matrices (``test_numpy_packing_is_jax_packing``)."""
    monkeypatch.setattr(jax_mrf, "_pack_matrices", _pack_matrices)
    monkeypatch.setattr(jax_mrf, "_pack_transpose_matrices", _pack_transpose_matrices)


def test_numpy_packing_is_jax_packing(monkeypatch):
    monkeypatch.undo()
    rng = np.random.RandomState(3)
    for k, d, g, C, C_out in ((7, 3, 8, 16, 16), (7, 1, 16, 8, 1), (3, 1, 1, 256, 256)):
        w = jnp.asarray(rng.randn(k, C, C_out).astype(np.float32))
        want, got = jax_mrf._pack_matrices(w, k, d, g, C, C_out), _pack_matrices(w, k, d, g, C, C_out)
        assert want[0] == got[0] and np.array_equal(np.asarray(want[1]), np.asarray(got[1]))
    for k, u, g_in, g_out, C_in, C_out in ((16, 8, 4, 8, 32, 16), (4, 2, 8, 16, 16, 8)):
        w = jnp.asarray(rng.randn(k, C_in, C_out).astype(np.float32))
        b = jnp.asarray(rng.randn(C_out).astype(np.float32))
        want, got = jax_mrf._pack_transpose_matrices(w, b, u, g_in, g_out), _pack_transpose_matrices(w, b, u, g_in, g_out)
        assert list(want[0]) == list(got[0]) and want[3] == got[3]
        for a, c in zip(want[1:3], got[1:3]):
            assert np.array_equal(np.asarray(a), np.asarray(c))


@pytest.mark.parametrize("n_tiles", [1, 2, 4])
@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_dynamic_stage_matches_pallas_per_tile_window(small_tiles, name, n_tiles):
    """The twin's dynamic int8 stage against JAX's ``fused_mrf`` (Pallas,
    interpret mode) at 1, 2 and 4 tiles, bf16 storage; one amax a batch
    row, the function before windows, is ~1e-2 off at 2 and 4 tiles."""
    B, C_in, upsample, post, resblock2 = STAGE_CASES[name]
    u = upsample[1] if upsample else 1
    L_in = n_tiles * TILE_STEPS // u
    x, weights, ups, pst = _case(7, B, L_in, C_in, 16, upsample, post, resblock2)
    want = np.asarray(
        jax_mrf.fused_mrf(
            jnp.asarray(x).astype(jnp.bfloat16), _to(weights, jnp.asarray), KERNEL_SIZES, DILATIONS,
            upsample=_to(ups, jnp.asarray), post=_to(pst, jnp.asarray), compute_dtype=jnp.bfloat16,
            interpret=True, quantize_int8=True,
        ).astype(jnp.float32)
    )
    tw, tu, tp = mrf.prepare_mrf_weights(
        _to(weights, torch.from_numpy), _to(ups, torch.from_numpy), _to(pst, torch.from_numpy),
        torch.bfloat16, quantize_int8=True,
    )
    xt = torch.from_numpy(x).to(torch.bfloat16)
    run = mrf.dynamic_windows(xt, tw, KERNEL_SIZES, DILATIONS, tu, tp, torch.bfloat16)
    assert (run is None) == (n_tiles == 1)
    if run is not None:
        assert (run.tile, run.n, run.seq) == (TILE_STEPS, n_tiles, n_tiles * TILE_STEPS)
    got = mrf.fused_mrf(xt, tw, KERNEL_SIZES, DILATIONS, upsample=tu, post=tp, compute_dtype=torch.bfloat16,
                        quantize_int8=True).float().numpy()
    rel = _rel_rms(got, want)
    print(f"{name} at {n_tiles} tiles: rel-RMS {rel:.2e} against JAX")
    _assert_int8_close(got, want)


# mel frames of the tiny config: under the knob its stages 1-3 (4 * frames
# rows each) span 5 tiles of 64 rows, stage 0 one (frames rows)
GENERATOR_FRAMES = 80


def test_generator_spanning_tiles_matches_jax(small_tiles):
    """The tiny generator on the int8 route with dynamic scales, stages 1-3
    at five tiles, against JAX's ``generator_apply_fused`` (every stage
    through the quantized kernel)."""
    cfg = _hifigan_cfg()
    _, variables, port, mel = _generator(cfg, seed=8, T=GENERATOR_FRAMES)
    calls = []
    jax_fused = jax_mrf.fused_mrf

    def counted(*args, **kwargs):
        out = jax_fused(*args, **kwargs)  # raises before counting where JAX falls back
        calls.append(kwargs["quantize_int8"])
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_mrf, "fused_mrf", counted)
        want = np.asarray(jax_apply_fused(cfg, variables["params"], jnp.asarray(mel), compute_dtype=jnp.bfloat16,
                                          interpret=True, quantize_int8=True))
    assert calls == [True] * 4
    tiles = []
    real = mrf.dynamic_windows

    def spy(*args, **kwargs):
        run = real(*args, **kwargs)
        tiles.append(0 if run is None else run.n)
        return run

    with torch.no_grad(), pytest.MonkeyPatch.context() as m:
        m.setattr(mrf, "dynamic_windows", spy)
        got = hifigan.generator_apply_fused(port, torch.from_numpy(mel), torch.bfloat16, quantize_int8=True).numpy()
    assert tiles == [0, 5, 5, 5]
    print(f"generator at {GENERATOR_FRAMES} frames: rel-RMS {_rel_rms(got, want):.2e} against JAX")
    _assert_int8_close(got, want)


DEFAULT_KS, DEFAULT_DS = (3, 7, 11), ((1, 3, 5),) * 3


def test_tile_helpers_are_jax_helpers():
    """The port's copies of the kernel's packing, reach and tile pickers give
    JAX's values at the default widths, and on the tiny config."""
    for g in (1, 2, 4, 8, 16):
        for k in (3, 4, 7, 11, 16):
            for d in (1, 3, 5):
                assert mrf.pack_offsets(k, d, g) == jax_mrf._pack_offsets(k, d, g)[0]
                assert mrf.conv_radius_rows(k, d, g) == jax_mrf._conv_radius_rows(k, d, g)
        for ks, ds in ((DEFAULT_KS, DEFAULT_DS), (KERNEL_SIZES, DILATIONS)):
            for two in (True, False):
                assert mrf.stack_radius_rows(ks, ds, g, two) == jax_mrf._stack_radius_rows(ks, ds, g, two)
    for rows in (8, 24, 127, 1016, 4096, 6144, 8200, 32768, 49152, 65536, 98304):
        for width in (128, 256, 512):
            for budget in (0, 6 << 20, 10 << 20, 48 << 20):
                assert mrf.pick_tile_rows(rows, width, budget) == jax_mrf._pick_tile_rows(rows, width, budget)


def _jax_call(L_in, C_in, C, upsample, post_k):
    """JAX's ``fused_mrf`` on the int8 route (bf16 storage) under
    ``jax.eval_shape``: its (Tp, Hp) and None where it runs, else its error.
    The packed weights are zeros of their shapes and the kernel is not
    traced: the geometry and its checks are JAX's own."""
    S, f = jax.ShapeDtypeStruct, jnp.float32
    w = [(S((len(ds), k, C, C), f), S((len(ds), C), f), S((len(ds), k, C, C), f), S((len(ds), C), f))
         for k, ds in zip(DEFAULT_KS, DEFAULT_DS)]
    seen = {}

    def pallas_call(kernel, out_shape, **kwargs):
        seen.update(tp=kernel.keywords["Tp"], hp=kernel.keywords["Hp"])
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    def pack(w_, k, d, g, C_, C_out=None):
        offs, _ = jax_mrf._pack_offsets(k, d, g)
        return offs, jnp.zeros((len(offs), g * C_, g * (C_ if C_out is None else C_out)), f)

    def fn(x, w, uw, ub, pw, pb):
        return jax_mrf.fused_mrf(x, w, DEFAULT_KS, DEFAULT_DS, upsample=None if uw is None else (uw, ub, upsample[1]),
                                 post=None if pw is None else (pw, pb), compute_dtype=jnp.bfloat16,
                                 quantize_int8=True, interpret=True)

    args = (S((1, L_in, C_in), jnp.bfloat16), w,
            S((upsample[0], C_in, C), f) if upsample else None, S((C,), f) if upsample else None,
            S((post_k, C, 1), f) if post_k else None, S((1,), f) if post_k else None)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_mrf.pl, "pallas_call", pallas_call)
        m.setattr(jax_mrf, "_pack_matrices", pack)
        m.setattr(jax_mrf, "_pack_transpose_matrices", JAX_PACK_TRANSPOSE)
        try:
            jax.eval_shape(fn, *args)
        except ValueError as e:
            return str(e)
    return seen["tp"], seen["hp"]


# odd frame counts (stage 0 refuses: tiles of 1,016, 1,032, 2,664 and 8
# rows), counts above 1,024 (stage 0 splits past 512 frames), the bulk's 768
FRAME_COUNTS = [1, 16, 100, 127, 128, 129, 256, 333, 511, 512, 513, 640, 768, 777, 1000, 1023, 1024, 1025,
                1536, 2048]


@pytest.mark.parametrize("frames", FRAME_COUNTS)
def test_tile_geometry_is_jax_fused_mrf(frames):
    """``jax_tile_geometry`` against JAX's ``fused_mrf`` at every default
    stage on the int8 route: tile and halo where the call runs, the
    refusal where it raises, for the call with the ConvTranspose prologue
    and, where that one raises, the call without it, which JAX's generator
    makes next."""
    L_in, c0 = frames, 512
    for i, (u, k_u) in enumerate(zip((8, 8, 2, 2), (16, 16, 4, 4))):
        C_in, C = c0 >> i, c0 >> (i + 1)
        post_k = 7 if i == 3 else None
        g = max(1, mrf.LANES // C)
        first = None
        for call in ((L_in, C_in, (k_u, u)), (L_in * u, C, None)):
            if call[2] is None and first is None:
                break  # JAX's generator makes the second call only where the first raises
            want = _jax_call(call[0], call[1], C, call[2], post_k)
            got = mrf.jax_tile_geometry(call[0], call[1], C, DEFAULT_KS, DEFAULT_DS, False, upsample=call[2],
                                        post_k=post_k, store=torch.bfloat16, quantize_int8=True)
            if isinstance(want, str):
                assert got.error == want, (frames, i, call)
            else:
                assert got.error is None and (got.tile, got.halo) == (want[0] * g, want[1] * g), (frames, i, call)
            first = got.error
        L_in *= u


@contextlib.contextmanager
def _exact_xla_sums():
    """JAX's XLA convs and ConvTransposes with exact sums: each runs in
    float64 (``jax.enable_x64``) and rounds to float32, then to the compute
    dtype, where XLA sums in float32 in an order of its own.  The port's
    ``xla_stage`` rounds exact sums so; with plain XLA the two sides part
    where a float32 sum lies within its rounding error of a bf16 midpoint
    (one output of 5,120 in the first conv of the 20-frame case), and the
    int8 codes of the stages after amplify that."""

    def exact(fn):
        def call(lhs, rhs, *args, preferred_element_type=None, **kwargs):
            with jax.enable_x64(True):
                y = fn(lhs.astype(jnp.float64), rhs.astype(jnp.float64), *args,
                       preferred_element_type=jnp.float64, **kwargs).astype(jnp.float32)
            return y.astype(preferred_element_type or lhs.dtype)

        return call

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.lax, "conv_general_dilated", exact(jax.lax.conv_general_dilated))
        m.setattr(jax.lax, "conv_transpose", exact(jax.lax.conv_transpose))
        yield


def _jax_int8(cfg, variables, mel, exact=False):
    """JAX's int8 generator (dynamic scales, bf16, interpret mode) and the
    input of each ``fused_mrf`` call that ran (a refused call raises before
    it is recorded): the first is the output of the stages before it."""
    inputs, jax_fused = [], jax_mrf.fused_mrf

    def spy(x, *args, **kwargs):
        out = jax_fused(x, *args, **kwargs)
        inputs.append(np.asarray(x.astype(jnp.float32)))
        return out

    with pytest.MonkeyPatch.context() as m, (_exact_xla_sums() if exact else contextlib.nullcontext()):
        m.setattr(jax_mrf, "fused_mrf", spy)
        want = np.asarray(jax_apply_fused(cfg, variables["params"], jnp.asarray(mel), compute_dtype=jnp.bfloat16,
                                          interpret=True, quantize_int8=True))
    return want, inputs


def _port_int8(port, mel, monkeypatch):
    """The port's int8 generator, with the ``quantize_int8`` of each twin
    call and the output of each ``xla_stage``."""
    quantized, xla_out = [], []
    twin, xla_stage = mrf.fused_mrf_plain, hifigan.xla_stage

    def twin_spy(*args, **kwargs):
        quantized.append(kwargs["quantize_int8"])
        return twin(*args, **kwargs)

    def xla_spy(*args, **kwargs):
        out = xla_stage(*args, **kwargs)
        xla_out.append(out.float().numpy())
        return out

    monkeypatch.setattr(mrf, "fused_mrf_plain", twin_spy)
    monkeypatch.setattr(hifigan, "xla_stage", xla_spy)
    with torch.no_grad():
        got = hifigan.generator_apply_fused(port, torch.from_numpy(mel), torch.bfloat16, quantize_int8=True).numpy()
    return got, quantized, xla_out


@pytest.mark.parametrize("frames", [17, 41])
def test_every_stage_refused_is_the_bf16_route(monkeypatch, frames):
    """At 17 and 41 frames JAX refuses every stage of the tiny config on the
    int8 route and runs each as XLA convs in bf16 (its unquantized XLA
    program, not its bf16 route's fused stages); the port runs
    ``xla_stage`` four times and no twin or kernel.  Within the int8 bar of
    JAX's output, and, with exact sums on both sides, within 1e-6 (the
    float32 tanh)."""
    cfg = _hifigan_cfg()
    _, variables, port, mel = _generator(cfg, seed=8, T=frames)
    stages = port.fused_weights(torch.bfloat16, quantize_int8=True)
    rungs = hifigan.int8_rungs(stages, frames, torch.bfloat16, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
    assert rungs == [hifigan.XLA_STAGE] * 4
    got, quantized, xla_out = _port_int8(port, mel, monkeypatch)
    assert quantized == [] and len(xla_out) == 4
    want, inputs = _jax_int8(cfg, variables, mel)
    assert inputs == []
    print(f"{frames} frames: max abs {np.abs(got - want).max():.3e}, rel-RMS {_rel_rms(got, want):.2e} "
          "against JAX's int8 route")
    _assert_int8_close(got, want)
    exact, _ = _jax_int8(cfg, variables, mel, exact=True)
    assert np.abs(got - exact).max() <= 1e-6


@pytest.mark.parametrize("resblock, frames", [("1", 20), ("2", 40)])
def test_refused_stage_0_runs_unquantized(monkeypatch, resblock, frames):
    """At 20 frames (ResBlock1) and 40 (ResBlock2) JAX refuses stage 0
    alone: the port runs it as JAX's XLA stage (``xla_stage``, no twin or
    kernel) and quantizes stages 1-3.  The waveform is within the int8 bar
    of JAX's.  Stage 0's output, against the input of JAX's first fused
    call: within 1e-3 rel-RMS (midpoint flips of XLA's float32 sums, one
    bf16 ulp each; K2's stage in its place was 5e-3 off), and bit for bit
    JAX's with exact sums on both sides, where the waveform is within 1e-5
    rel-RMS."""
    cfg = _hifigan_cfg(resblock)
    _, variables, port, mel = _generator(cfg, seed=8, T=frames)
    stages = port.fused_weights(torch.bfloat16, quantize_int8=True)
    rungs = hifigan.int8_rungs(stages, frames, torch.bfloat16, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
    assert rungs == [hifigan.XLA_STAGE] + [hifigan.FUSED] * 3
    got, quantized, xla_out = _port_int8(port, mel, monkeypatch)
    assert quantized == [True] * 3 and len(xla_out) == 1
    want, inputs = _jax_int8(cfg, variables, mel)
    assert len(inputs) == 3 and inputs[0].shape == xla_out[0].shape
    stage_rel = _rel_rms(xla_out[0], inputs[0])
    print(f"{frames} frames, resblock {resblock}: max abs {np.abs(got - want).max():.3e}, rel-RMS "
          f"{_rel_rms(got, want):.2e} against JAX's int8 route; stage 0 {stage_rel:.2e}")
    _assert_int8_close(got, want)
    assert stage_rel <= 1e-3
    exact, exact_inputs = _jax_int8(cfg, variables, mel, exact=True)
    np.testing.assert_array_equal(xla_out[0], exact_inputs[0])
    assert _rel_rms(got, exact) <= 1e-5


def test_xla_prologue_rung_matches_jax():
    """A stage whose prologue alone the kernel refuses (tile not divisible
    by its ConvTranspose's rows: stride 64 at 16 channels) takes JAX's
    second rung: the ConvTranspose on XLA in bf16, then the quantized MRF."""
    cfg = _hifigan_cfg()
    cfg = dataclasses.replace(cfg, upsample_rates=(64, 2, 2), upsample_kernel_sizes=(128, 4, 4))
    _, variables, port, mel = _generator(cfg, seed=9, T=6)
    stages = port.fused_weights(torch.bfloat16, quantize_int8=True)
    rungs = hifigan.int8_rungs(stages, 6, torch.bfloat16, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
    assert rungs[0] == hifigan.XLA_PROLOGUE
    calls = []
    jax_fused = jax_mrf.fused_mrf

    def counted(*args, **kwargs):
        out = jax_fused(*args, **kwargs)
        calls.append(kwargs.get("upsample") is not None)
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_mrf, "fused_mrf", counted)
        want = np.asarray(jax_apply_fused(cfg, variables["params"], jnp.asarray(mel), compute_dtype=jnp.bfloat16,
                                          interpret=True, quantize_int8=True))
    assert calls[0] is False and len(calls) == 3
    with torch.no_grad():
        got = hifigan.generator_apply_fused(port, torch.from_numpy(mel), torch.bfloat16, quantize_int8=True).numpy()
    print(f"stride-64 stage 0: rel-RMS {_rel_rms(got, want):.2e} against JAX")
    _assert_int8_close(got, want)
