"""The per-conv wgmma pipeline of the generator stages
(``csrc/mrf_conv_wgmma.cuh``) on the CPU: its storage, its plan and its
MAC count, on its four routes (bf16 and static int8 at C = 256 and 128;
the float32 route's 3xTF32 and dynamic int8 at C = 256, 128, 64 and 32).

No CUDA kernel runs here.  ``mrf_conv_stage_plain`` stores what the
kernel's epilogues store (each conv's bf16 operand, int8 codes or TF32
parts hi and lo, chunk-major; float32 only for the residual trunk and the
resblocks' sum, and, with dynamic scales, the values a quantize pass
reads) and must give today's twins' output: bit for bit
``fused_mrf_plain(bf16_dots=True)`` on the bf16 route and
``fused_mrf_plain(quantize_int8=True)`` with the same static scales or
none on the int8 routes; on the float32 route ``fused_mrf_plain`` to
3xTF32's precision (rtol 1e-5 + atol 1e-4, the card's bar).  The plan is
the C header's (``csrc/mrf_conv_plan.h``), built with the host compiler
into the plan library and asked through ``ops/mrf.py``; the tests hold it
to the default stages on cards of 114 to 132 SMs and pin the MACs it
issues to counts worked out by hand.  The new routes' twins are also held
to JAX's ``fused_mrf`` (float32, dynamic int8) in interpret mode.
"""

import numpy as np
import pytest
import torch

from viettts_tpu_torch.config import Config
from viettts_tpu_torch.ops import mrf
from viettts_tpu_torch.utils import flops

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3


def _weights(rng, C, resblock2=False):
    blocks = []
    for k, d in zip(KS, DS):
        n, s = len(d), 0.5 / (k * C) ** 0.5

        def t(*shape, sc):
            return torch.from_numpy((rng.standard_normal(shape) * sc).astype(np.float32))

        w2 = None if resblock2 else t(n, k, C, C, sc=s)
        b2 = None if resblock2 else t(n, C, sc=0.05)
        blocks.append((t(n, k, C, C, sc=s), t(n, C, sc=0.05), w2, b2))
    return blocks


@pytest.fixture(scope="module")
def stages():
    rng = np.random.default_rng(14)
    out = {}
    for C in (128, 256):
        w32 = _weights(rng, C)
        out[C] = (w32, mrf.prepare_mrf_weights(w32, compute_dtype=torch.bfloat16)[0],
                  mrf.prepare_mrf_weights(w32, quantize_int8=True)[0])
    return out


def _flat_conv_inputs(x, weights, route, act):
    """What each MRF conv of ``fused_mrf_plain``'s stack quantizes or
    rounds, in flat conv order: the operand it multiplies."""
    seen = []

    def conv(inp, w, b, j, d, index):
        if route == "bf16":
            seen.append(inp.to(torch.bfloat16))
            return mrf._conv_same(inp.to(torch.bfloat16).float(), mrf._dense(w)[j], b[j], d)
        c127 = mrf._f32(127.0, inp)
        a = torch.clamp_min(act[index], 1e-12)
        seen.append(torch.round(torch.clamp(inp * (c127 / a), -127.0, 127.0)).to(torch.int8))
        return mrf._conv_int8(inp, w.codes[j], w.scales[j], b[j], d, act[index])

    mrf._mrf_stack(x.float().transpose(1, 2), weights, KS, DS, conv)
    return seen


@pytest.mark.parametrize("route", ["bf16", "int8"])
@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("L", [5, 61, 203])
def test_operand_storage_twin_equals_todays_twins(stages, route, C, L):
    """At ragged L (shorter than the k = 11 convs' reach of 50 rows, and
    not a multiple of any tile), the stored operands are the operands of
    today's twins, bit for bit, and so is the stage output: int8 codes,
    bf16 values and every float32 sum."""
    w32, wb, w8 = stages[C]
    rng = np.random.default_rng(C + L)
    x = torch.from_numpy(rng.standard_normal((2, L, C)).astype(np.float32))
    ops = []
    if route == "bf16":
        x = x.to(torch.bfloat16).float()
        got = mrf.mrf_conv_stage_plain(x, wb, KS, DS, "bf16", operands=ops)
        want = mrf.fused_mrf_plain(x, wb, KS, DS, bf16_dots=True)
        seen = _flat_conv_inputs(x, wb, "bf16", None)
        # the stage input's operand is stored once and read by each resblock's first conv
        stored = [ops[0]] + ops[1:6] + [ops[0]] + ops[6:11] + [ops[0]] + ops[11:]
    else:
        _, amax = mrf.mrf_walk(x.transpose(1, 2), w32, KS, DS, lambda j, y: y.abs().amax())
        act = torch.stack(amax)
        got = mrf.mrf_conv_stage_plain(x, w8, KS, DS, "int8", act, operands=ops)
        want = mrf.fused_mrf_plain(x, w8, KS, DS, quantize_int8=True, act_scales=act)
        seen = _flat_conv_inputs(x, w8, "int8", act)
        stored = ops
    assert len(stored) == len(seen) == mrf.n_convs(wb)
    for i, (p, s) in enumerate(zip(stored, seen)):
        assert p.dtype == s.dtype and p.shape == (2, C // (16 // p.element_size()), L, 16 // p.element_size())
        assert torch.equal(mrf.unpack_operand(p), s), f"conv {i}: stored operand differs"
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_operand_and_weight_layouts_are_the_kernels():
    """``pack_operand`` puts channel c of row l of batch row b at flat
    element ((b * C / e + c / e) * L + l) * e + c % e, the kernel's
    ``put_operand`` address, and ``conv_slots`` puts weight (tap t, input
    ci, output co) at [chunk ci / KC][t][plane (ci % KC) / e][co][ci % e],
    the slot a bulk copy lands as the K-major B operand; both for bf16
    (e = 8, KC = 64) and int8 (e = 16, KC = 128)."""
    rng = np.random.default_rng(3)
    B, C, L, D, k = 2, 256, 7, 2, 3
    for dtype, e, kc in ((torch.bfloat16, 8, 64), (torch.int8, 16, 128)):
        op = torch.from_numpy(rng.integers(-127, 128, (B, C, L))).to(dtype)
        flat = mrf.pack_operand(op).reshape(-1)
        for b, c, l in ((0, 0, 0), (1, 255, 6), (1, 17, 3), (0, 130, 5)):
            assert flat[((b * C // e + c // e) * L + l) * e + c % e] == op[b, c, l]
        assert torch.equal(mrf.unpack_operand(mrf.pack_operand(op)), op)
        w = torch.from_numpy(rng.integers(-127, 128, (D, k, C, C))).to(dtype)
        slots = mrf.conv_slots(w)
        assert slots.shape == (D, C // kc, k, kc // e, C, e) and slots.is_contiguous()
        for d, t, ci, co in ((0, 0, 0, 0), (1, 2, 255, 3), (1, 1, 77, 200), (0, 2, 129, 255)):
            assert slots[d, ci // kc, t, ci % kc // e, co, ci % e] == w[d, t, ci, co]
    assert mrf.conv_slots(torch.zeros(1, 3, 192, 64, dtype=torch.int8)) is None  # no int8 chunk divides 192
    assert mrf.conv_slots(torch.zeros(1, 3, 48, 48, dtype=torch.int8)) is None  # nor 48 bytes


def test_prepared_weights_carry_their_slots():
    """``prepare_mrf_weights`` gives the bf16 route ``Bf16Conv``, the int8
    route ``Int8Conv`` and the float32 route ``Tf32Conv`` with the wgmma
    slots at C = 128 and 64 (int8 at C = 64 in chunks of its own 64
    bytes), and the twins read the same dense weights as before."""
    rng = np.random.default_rng(5)
    for C, has in ((128, True), (64, True)):
        w32 = _weights(rng, C)
        wb, _, _ = mrf.prepare_mrf_weights(w32, compute_dtype=torch.bfloat16)
        w8, _, _ = mrf.prepare_mrf_weights(w32, quantize_int8=True)
        w1 = wb[0][0]
        assert isinstance(w1, mrf.Bf16Conv) and torch.equal(w1.w, w32[0][0].to(torch.bfloat16))
        assert isinstance(w8[0][0], mrf.Int8Conv)
        assert (w8[0][0].slots is not None) == has
        if has:
            assert torch.equal(w1.slots, mrf.conv_slots(w1.w)) and torch.equal(w8[0][0].slots, mrf.conv_slots(w8[0][0].codes))
        wf, _, _ = mrf.prepare_mrf_weights(w32)
        assert isinstance(wf[0][0], mrf.Tf32Conv) and torch.equal(wf[0][0].w, w32[0][0])
        assert torch.equal(wf[0][0].slots, mrf.tf32_slots(w32[0][0]))


def test_route_names_the_stages_the_plan_takes():
    """The C plan takes the bf16 and static int8 stages of width 128 and 256
    where the card measured it faster than ``mma_conv_kernel``: every bf16
    stage; int8 but at C = 256 below 4,096 rows (B=2 at 128 mel frames:
    2,048); no other route or width."""
    for B, frames in ((1, 512), (2, 128), (64, 768)):
        for C, rows in ((256, 8), (128, 64)):
            assert mrf.conv_takes("bf16", B, frames * rows, C)
            assert mrf.conv_takes("int8", B, frames * rows, C) == (C == 128 or B * frames * rows >= 4096)
        for C in (32, 64, 512):
            assert not mrf.conv_takes("bf16", B, frames * 16384 // C, C)
            assert not mrf.conv_takes("int8", B, frames * 16384 // C, C)
    assert mrf.conv_takes("bf16", 1, 5, 256) and not mrf.conv_takes("int8", 1, 5, 256)
    assert mrf.conv_takes("int8", 1, 4096, 256) and not mrf.conv_takes("int8", 1, 4095, 256)
    assert not mrf.conv_takes("float32", 64, 6144, 256)
    assert mrf.fused_route_name("int8", False) is None  # dynamic scales keep mma_conv_kernel


@pytest.mark.parametrize("sms", [114, 120, 124, 128, 132])
def test_plan_covers_every_default_stage(sms):
    """Every conv of the default generator's C = 256 and 128 stages, at the
    lead's B=1 (512 frames), B=2 (128) and the bulk B=64 (768), plans on
    a card of 114-132 SMs: a tile that divides C, a window holding the
    tile and the conv's reach in whole 16-row steps (two TMA boxes past
    256 rows), a ring of 3-6 slots in 227 KB, and a grid of at most one
    block an SM over every tile."""
    h = Config().hifigan
    for B, frames in ((1, 512), (2, 128), (64, 768)):
        for _, C, _, u, L_in, _ in flops.stage_shapes(h, frames):
            L = L_in * u
            if C not in (128, 256):
                continue
            assert mrf.conv_takes("bf16", B, L, C)
            for k, dils in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                for dil in set(dils) | {1}:
                    p = mrf.conv_plan(B, L, C, k, dil, sms)
                    assert p is not None, (B, L, C, k, dil, sms)
                    assert C % p.bn == 0 and p.bm % 128 == 0 and p.bn * p.bm // 2 <= 128 * 128
                    assert p.win >= p.bm + (k - 1) * dil and p.win % 16 == 0 and p.win <= 512
                    assert p.xbox == (p.win if p.win <= 256 else p.win // 2)
                    # two window chunks, the ring, the eight warps' 16-row epilogue strips
                    strips = 8 * 16 * (p.bn + 4) * 4
                    assert 3 <= p.stages <= 6 and p.smem == 256 + 2 * 128 * p.win + 128 * p.bn * p.stages + strips
                    assert p.smem <= mrf.SMEM_LIMIT
                    assert p.tiles == B * -(-L // p.bm) * (C // p.bn) and p.ctas == min(p.tiles, sms)


def test_plan_reaches_every_tile_shape_of_the_card_tests():
    """The cases ``tests/test_torch_gpu.py`` runs the pipeline at reach each
    of its tile shapes on the H100 (132 SMs): 256 x 128 at B=64, 128 x 64
    at B=1 and B=2, 128 x 128 where 128-row tiles of every channel fill one
    wave."""
    from test_torch_gpu import CONV_CASES, STAGE_ROWS

    shapes = set()
    for C in (128, 256):
        for B, frames, L in CONV_CASES:
            p = mrf.conv_plan(B, L or frames * STAGE_ROWS[C], C, 11, 5, 132)
            shapes.add((p.bm, p.bn))
    assert shapes == {(256, 128), (128, 128), (128, 64)}


def test_issued_macs_are_pinned_by_hand():
    """The MACs the pipeline issues for a stage's 18 convs (126 taps), at
    two shapes on 132 SMs:

    * the bulk C = 256 stage, B=64 x 6,144 rows: 256 x 128 tiles divide it,
      so it issues exactly B * L * C^2 * 126 = 64 * 6144 * 65536 * 126;
    * C = 128, B=2 x 1,000 rows: 128 x 64 tiles (32 of them: one wave
      beats 8 tiles of 256 x 128 and 16 of 128 x 128 by the plan's cost),
      each batch row padded to 1,024 rows: 2 * 1024 * 128 * 128 * 126."""
    assert mrf.conv_issued_macs(64, 6144, 256, KS, DS, False, 132) == 3_246_995_275_776
    assert mrf.conv_plan(2, 1000, 128, 3, 1, 132)[:2] == (128, 64)
    assert mrf.conv_issued_macs(2, 1000, 128, KS, DS, False, 132) == 4_227_858_432
    # mrf_issued_flops counts the same tiles on the routes the pipeline takes
    h = Config().hifigan
    assert flops.mrf_issued_flops(h, 64, 6144, 256, "bfloat16", 132) == 2 * 3_246_995_275_776
    assert flops.mrf_issued_flops(h, 2, 1000, 128, "int8", 132, int8_static=True) == 2 * 4_227_858_432


def test_plan_library_is_the_header():
    """The plan library is built from ``csrc/mrf_conv_plan.cpp`` with the
    host compiler, and answers for shapes the header refuses: C not a
    multiple of 128, an even kernel size."""
    assert mrf.conv_plan(1, 100, 192, 3, 1, 132) is None
    assert mrf.conv_plan(1, 100, 128, 4, 1, 132) is None
    assert mrf.conv_plan(1, 100, 128, 3, 1, 132) is not None
    assert not mrf.conv_takes("bf16", 1, 100, 192)


def test_resblock2_storage_twin(stages):
    """ResBlock2 (one dilated conv a unit) alternates its operands between
    two buffers in the kernel; the twin's output still equals the int8
    twin's bit for bit."""
    rng = np.random.default_rng(9)
    w32 = _weights(rng, 128, resblock2=True)
    w8, _, _ = mrf.prepare_mrf_weights(w32, quantize_int8=True)
    x = torch.from_numpy(rng.standard_normal((1, 61, 128)).astype(np.float32))
    _, amax = mrf.mrf_walk(x.transpose(1, 2), w32, KS, DS, lambda j, y: y.abs().amax())
    act = torch.stack(amax)
    got = mrf.mrf_conv_stage_plain(x, w8, KS, DS, "int8", act)
    assert torch.equal(got, mrf.fused_mrf_plain(x, w8, KS, DS, quantize_int8=True, act_scales=act))


# ---------------------------------------------------------------------------
# The float32 route (3xTF32) and dynamic int8 on the per-conv wgmma pipeline.
# ---------------------------------------------------------------------------

NEW_ROUTES = ("tf32", "int8_dynamic")
NARROW_ROWS = {256: 8, 128: 64, 64: 128, 32: 256}  # rows of the default stage of width C a mel frame


@pytest.fixture(scope="module")
def narrow_stages():
    rng = np.random.default_rng(15)
    out = {}
    for C in (32, 64, 128, 256):
        w32 = _weights(rng, C)
        out[C] = (w32, mrf.prepare_mrf_weights(w32)[0], mrf.prepare_mrf_weights(w32, quantize_int8=True)[0])
    return out


def _dynamic_conv_inputs(x, weights):
    """What each MRF conv of ``fused_mrf_plain``'s dynamic int8 stack
    quantizes, in flat conv order: its codes and its input's row amax."""
    seen = []

    def conv(inp, w, b, j, d, index):
        a = mrf.row_amax(inp)
        seen.append((torch.round(inp * (mrf._f32(127.0, inp) / torch.clamp_min(a, 1e-30))[:, None, None])
                     .to(torch.int8), a))
        return mrf._conv_int8(inp, w.codes[j], w.scales[j], b[j], d, None)

    mrf._mrf_stack(x.float().transpose(1, 2), weights, KS, DS, conv)
    return seen


@pytest.mark.parametrize("route", NEW_ROUTES)
@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("L", [5, 61, 203])
def test_new_route_storage_twin_equals_todays_twins(narrow_stages, route, C, L):
    """The storage twins of the new routes against today's twins at ragged
    L: dynamic int8 bit for bit, every stored code and every conv's row
    amax too (the stage input's codes stored once, read by each resblock's
    first conv); the float32 route within rtol 1e-5 + atol 1e-5 (3xTF32
    keeps 22 of 24 bits of each part), every stored operand the TF32
    parts (hi, lo) of a float32 value."""
    w32, wf, w8 = narrow_stages[C]
    rng = np.random.default_rng(C + L)
    x = torch.from_numpy(rng.standard_normal((2, L, C)).astype(np.float32))
    ops, amaxes = [], []
    if route == "int8_dynamic":
        got = mrf.mrf_conv_stage_plain(x, w8, KS, DS, route, operands=ops, amaxes=amaxes)
        want = mrf.fused_mrf_plain(x, w8, KS, DS, quantize_int8=True)
        seen = _dynamic_conv_inputs(x, w8)
        stored = [ops[0]] + ops[1:6] + [ops[0]] + ops[6:11] + [ops[0]] + ops[11:]
        assert len(stored) == len(seen) == len(amaxes) == mrf.n_convs(w8)
        for i, (p, (codes, a)) in enumerate(zip(stored, seen)):
            assert p.dtype == torch.int8 and p.shape == (2, C // 16, L, 16)
            assert torch.equal(mrf.unpack_operand(p), codes), f"conv {i}: stored codes differ"
            assert torch.equal(amaxes[i], a), f"conv {i}: row amax differs"
        assert torch.equal(got, want)
    else:
        got = mrf.mrf_conv_stage_plain(x, wf, KS, DS, route, operands=ops)
        want = mrf.fused_mrf_plain(x, wf, KS, DS)
        assert len(ops) == 1 + 3 * (2 * len(DS[0]) - 1)  # the stage input, then each operand a conv writes
        for p in ops:
            assert p.dtype == torch.float32 and p.shape == (2, C // 2, L, 4)
            hi, lo = mrf.unpack_operand(p).unbind(1)
            assert torch.equal(hi, mrf.tf32_round(hi)) and torch.equal(lo, mrf.tf32_round(lo))
            assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())  # lo: at most half an ulp of hi's TF32
        assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())


def test_tf32_layouts_are_the_kernels():
    """``tf32_slots`` puts weight (tap t, input ci, output co) part hi at
    [chunk ci / 16][t][plane ci % 16 / 4][co][ci % 4] and part lo 4 planes
    on, ``tf32_split``'s parts; ``pack_operand`` of the parts [B, 2, C, L]
    puts channel c of row l at plane (c / 16) * 8 + part * 4 + c % 16 / 4,
    element c % 4, the epilogue's addresses."""
    rng = np.random.default_rng(4)
    D, k, C = 2, 3, 64
    w = torch.from_numpy(rng.standard_normal((D, k, C, C)).astype(np.float32))
    slots = mrf.tf32_slots(w)
    split = mrf.tf32_split(w)  # [D, 2, k, C_out, C_in]
    assert slots.shape == (D, C // 16, k, 8, C, 4) and slots.is_contiguous()
    for d, t, ci, co in ((0, 0, 0, 0), (1, 2, 63, 3), (1, 1, 17, 40), (0, 2, 34, 63)):
        for part in (0, 1):
            assert slots[d, ci // 16, t, part * 4 + ci % 16 // 4, co, ci % 4] == split[d, part, t, co, ci]
    assert mrf.tf32_slots(torch.zeros(1, 3, 40, 40)) is None
    B, L = 2, 5
    op = torch.from_numpy(rng.standard_normal((B, 2, C, L)).astype(np.float32))
    flat = mrf.pack_operand(op).reshape(-1)
    for b, part, c, l in ((0, 0, 0, 0), (1, 1, 63, 4), (1, 0, 21, 2), (0, 1, 38, 3)):
        plane = c // 16 * 8 + part * 4 + c % 16 // 4
        assert flat[((b * C // 2 + plane) * L + l) * 4 + c % 4] == op[b, part, c, l]
    assert torch.equal(mrf.unpack_operand(mrf.pack_operand(op)), op)


@pytest.mark.parametrize("sms", [114, 120, 124, 128, 132])
def test_plan_covers_the_new_routes(sms):
    """Every conv of every default stage (C = 256, 128, 64 and 32), at the
    lead's B=1 (512 frames), B=2 (128) and the bulk B=64 (768), plans on
    the float32 (tf32) and dynamic int8 routes on a card of 114-132 SMs:
    a tile whose bn divides C (bn = C at C = 64 and 32), chunks of 8
    planes (int8 at C = 64 and 32: C's own 4 and 2), a window of the tile
    and the conv's reach, a ring of 3-6 slots, all within 232,448 bytes."""
    h = Config().hifigan
    for route in NEW_ROUTES:
        for B, frames in ((1, 512), (2, 128), (64, 768)):
            for _, C, _, u, L_in, _ in flops.stage_shapes(h, frames):
                L = L_in * u
                planes = 8 if route == "tf32" or C >= 128 else C // 16
                for k, dils in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                    for dil in set(dils) | {1}:
                        p = mrf.conv_plan(B, L, C, k, dil, sms, route)
                        assert p is not None, (route, B, L, C, k, dil, sms)
                        assert C % p.bn == 0 and (p.bn == C if C < 128 else p.bn in (64, 128))
                        assert p.planes == planes and p.bm in (128, 256)
                        assert p.win >= p.bm + (k - 1) * dil and p.win % 16 == 0 and p.win <= 512
                        strips = 8 * 16 * (p.bn + 4) * 4
                        chunk = 16 * p.planes
                        assert 3 <= p.stages <= 6
                        assert p.smem == 256 + 2 * chunk * p.win + chunk * p.bn * p.stages + strips
                        assert p.smem <= mrf.SMEM_LIMIT
                        assert p.tiles == B * -(-L // p.bm) * (C // p.bn) and p.ctas == min(p.tiles, sms)


def test_new_tiles_issued_macs_are_pinned_by_hand():
    """The MACs the pipeline issues on the new tiles, 132 SMs:

    * float32 C = 64, the bulk stage (B=64 x 98,304 rows): 256 x 64 tiles
      (24,576 tiles, 187 waves, cost 187 * 320 * 128 against 373 waves of
      128 x 64 at 192 * 128) divide it: B * L * C^2 * 126 = 64 * 98304 *
      4096 * 126;
    * dynamic int8 C = 32, B=2 x 1,000 rows: 128 x 32 tiles (16 tiles, one
      wave, cost 192 * 96 against 8 tiles of 256 x 32 at 320 * 96), each
      row padded to 1,024 rows: 2 * 1024 * 32 * 32 * 126; chunks of 32
      bytes (2 planes)."""
    assert mrf.conv_plan(64, 98304, 64, 3, 1, 132, "tf32")[:3] == (256, 64, 8)
    assert mrf.conv_issued_macs(64, 98304, 64, KS, DS, False, 132, "tf32") == 3_246_995_275_776
    assert mrf.conv_plan(2, 1000, 32, 3, 1, 132, "int8_dynamic")[:3] == (128, 32, 2)
    assert mrf.conv_issued_macs(2, 1000, 32, KS, DS, False, 132, "int8_dynamic") == 264_241_152
    h = Config().hifigan
    assert flops.mrf_issued_flops(h, 64, 98304, 64, "float32", 132) == 2 * 3_246_995_275_776
    assert flops.mrf_issued_flops(h, 2, 1000, 32, "int8", 132) == 2 * 264_241_152


def test_router_takes_the_new_routes_where_they_won():
    """The float32 route takes the pipeline at every width and shape
    measured (C = 256 to 32 at B=1 x 512, B=2 x 128, B=64 x 768 frames);
    dynamic int8 too, but at C = 256 below 4,096 rows, as static int8
    (B=2 x 128 frames: 2,048 rows, where it lost); neither beyond those
    widths."""
    for B, frames in ((1, 512), (2, 128), (64, 768)):
        for C, rows in NARROW_ROWS.items():
            L = frames * rows
            assert mrf.conv_takes("tf32", B, L, C)
            assert mrf.conv_takes("int8_dynamic", B, L, C) == (C != 256 or B * L >= 4096)
    for C in (16, 48, 192, 512):
        assert not mrf.conv_takes("tf32", 1, 4096, C) and not mrf.conv_takes("int8_dynamic", 1, 4096, C)
    assert mrf.conv_route_name("float32") == "tf32" and mrf.conv_route_name("int8") == "int8_dynamic"
    assert mrf.conv_route_name("int8", True) == "int8" and mrf.conv_route_name("bfloat16") == "bf16"


@pytest.mark.parametrize("route", NEW_ROUTES)
def test_new_route_twins_match_jax(route):
    """The storage twins of the float32 and dynamic int8 routes against
    JAX's ``fused_mrf`` in interpret mode at a tiny width (C = 32, one JAX
    time tile, where its dynamic amax is the port's row amax): float32 at
    2e-5 of the output scale (``tests/test_torch_mrf.py``'s bar), int8
    rel-RMS 5e-3 and 0.02 of max(|ref|, 1) (``tests/test_torch_int8.py``'s)."""
    import jax.numpy as jnp

    from viettts_tpu.ops.mrf import fused_mrf as jax_fused_mrf
    from tests.test_torch_mrf import DILATIONS, KERNEL_SIZES, _case, _to

    x, weights, _, _ = _case(7, 2, 256, 32, 32, None, False)
    dynamic = route == "int8_dynamic"
    want = np.asarray(jax_fused_mrf(jnp.asarray(x), _to(weights, jnp.asarray), KERNEL_SIZES, DILATIONS,
                                    compute_dtype=jnp.float32, interpret=True, quantize_int8=dynamic))
    tw, _, _ = mrf.prepare_mrf_weights(_to(weights, torch.from_numpy), quantize_int8=dynamic)
    got = mrf.mrf_conv_stage_plain(torch.from_numpy(x), tw, KERNEL_SIZES, DILATIONS, route).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    if dynamic:
        rel = float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))
        assert rel <= 5e-3 and np.abs(got - want).max() <= 0.02 * scale
    else:
        assert np.abs(got - want).max() <= 2e-5 * scale
