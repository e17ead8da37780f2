"""The fused MRF pipeline of K2 and K3 (``csrc/mrf_fused.cuh``) on the
CPU: its tile schedule in plain PyTorch (``fused_mrf_tiled``) against the
stage twin ``fused_mrf_plain`` and against JAX's Pallas ``fused_mrf`` in
interpret mode, its launch plan (``plan_fused``) against the shared memory
of every H100 and against the kernel source, and the MACs it issues,
pinned to counts worked out by hand.

The twin and the schedule run the same float32 convs on windows of
different lengths, so they agree to 1e-6 (the sums of a conv may be taken
in another order for another length); the bf16 route rounds the same
operands on both sides, and the int8 convs are exact.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viettts_tpu.ops.mrf import fused_mrf as jax_fused_mrf
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.ops import _build, mrf
from viettts_tpu_torch.utils import flops

KERNEL_SIZES = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
C = 32  # the narrowest width the fused pipeline takes


def _weights(rng, C, resblock2, kernel_sizes=KERNEL_SIZES, dilations=DILATIONS):
    def w(*shape, s):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    out = []
    for k, dils in zip(kernel_sizes, dilations):
        n, s = len(dils), 0.5 / np.sqrt(k * C)
        w2 = None if resblock2 else w(n, k, C, C, s=s)
        b2 = None if resblock2 else w(n, C, s=0.05)
        out.append((w(n, k, C, C, s=s), w(n, C, s=0.05), w2, b2))
    return out


def _plan(L, resblock2, route="bf16", B=2, sms=132):
    return mrf.plan_fused(route, C, KERNEL_SIZES, DILATIONS, resblock2, B, L, sms)


def _tile(resblock2):
    """The tile rows of the plan at short lengths: one tile, so the
    fewest rows a tile computes, 64 or the window's slack."""
    return _plan(1, resblock2).bm


LENGTHS = ["1", "7", "tile-1", "tile", "tile+1", "3*tile+5"]


def _length(name, tile):
    return eval(name, {"tile": tile})


@pytest.mark.parametrize("resblock2", [False, True], ids=["resblock1", "resblock2"])
@pytest.mark.parametrize("length", LENGTHS)
def test_tile_schedule_matches_the_twin(length, resblock2):
    """Float32: tiles, windows and re-zeroing give the twin's stage to 1e-6."""
    rng = np.random.RandomState(0)
    L = _length(length, _tile(resblock2))
    weights = _weights(rng, C, resblock2)
    x = torch.from_numpy(rng.randn(2, L, C).astype(np.float32))
    plan = _plan(L, resblock2)
    assert plan.tiles_per_row == -(-L // plan.bm)
    want = mrf.fused_mrf_plain(x, weights, KERNEL_SIZES, DILATIONS)
    got = mrf.fused_mrf_tiled(x, weights, KERNEL_SIZES, DILATIONS, plan)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("resblock2", [False, True], ids=["resblock1", "resblock2"])
@pytest.mark.parametrize("length", LENGTHS)
def test_tile_schedule_matches_the_twin_on_bf16_dots(length, resblock2):
    """The bf16 route's operands (bf16 of each conv's lrelu input) rounded
    on both sides: the schedule is the twin's with ``bf16_dots``.  A float32
    conv over a window and over the whole sequence may differ by an ulp,
    which can flip the bf16 rounding of an operand (2^-8 of that element):
    rel-RMS 1e-4 and 1e-3 of the output scale, ten times inside the card's
    bar against this twin (tests/test_torch_gpu.py), where it is exact
    elsewhere."""
    rng = np.random.RandomState(1)
    L = _length(length, _tile(resblock2))
    weights = _weights(rng, C, resblock2)
    x = torch.from_numpy(rng.randn(1, L, C).astype(np.float32))
    plan = _plan(L, resblock2, route="bf16", B=1)
    want = mrf.fused_mrf_plain(x, weights, KERNEL_SIZES, DILATIONS, bf16_dots=True)
    got = mrf.fused_mrf_tiled(x, weights, KERNEL_SIZES, DILATIONS, plan, bf16_dots=True)
    diff = got - want
    assert diff.pow(2).mean().sqrt().item() <= 1e-4 * want.pow(2).mean().sqrt().item()
    assert diff.abs().max().item() <= 1e-3 * max(want.abs().max().item(), 1.0)


@pytest.mark.parametrize("length", ["7", "tile+1", "3*tile+5"])
def test_tile_schedule_matches_the_twin_on_static_int8(length):
    """Static int8 scales are the same for every tile, so each windowed
    int8 conv is the twin's, and so is the stage."""
    rng = np.random.RandomState(2)
    L = _length(length, _tile(False))
    weights = _weights(rng, C, False)
    x = torch.from_numpy(rng.randn(2, L, C).astype(np.float32))
    _, amax = mrf.mrf_walk(x.transpose(1, 2), weights, KERNEL_SIZES, DILATIONS, lambda j, y: 0.8 * y.abs().amax())
    act = torch.stack(amax)
    tw, _, _ = mrf.prepare_mrf_weights(weights, quantize_int8=True)
    kw = dict(quantize_int8=True, act_scales=act)
    want = mrf.fused_mrf_plain(x, tw, KERNEL_SIZES, DILATIONS, **kw)
    got = mrf.fused_mrf_tiled(x, tw, KERNEL_SIZES, DILATIONS, _plan(L, False, route="int8"), **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,L", [(2, 32768), (1, 40448), (64, 196608)])
def test_tile_schedule_of_the_planned_windows(B, L):
    """The windows the plan takes at real lengths (384 to 496 rows, two TMA
    boxes each) on a short stack: the schedule is the twin's."""
    rng = np.random.RandomState(3)
    kernel_sizes, dilations = (3, 11), ((1, 3, 5), (1, 3, 5))
    weights = _weights(rng, C, False, kernel_sizes, dilations)
    plan = mrf.plan_fused("bf16", C, kernel_sizes, dilations, False, B, L, 132)
    assert plan.win > mrf.FUSED_BOX
    x = torch.from_numpy(rng.randn(B, min(L, 3 * plan.bm + 5), C).astype(np.float32))
    want = mrf.fused_mrf_plain(x, weights, kernel_sizes, dilations)
    got = mrf.fused_mrf_tiled(x, weights, kernel_sizes, dilations, plan._replace(
        tiles_per_row=-(-x.shape[1] // plan.bm)))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_re_zeroing_outside_the_sequence_is_what_makes_the_edges():
    """Without the mask after each conv the halo rows past L would carry
    bias and neighbours into the next conv: a short L shows it.  The twin
    differs there from a schedule that skips the mask (``keep`` all ones),
    so the tests above see the re-zeroing."""
    rng = np.random.RandomState(4)
    L = 7
    weights = _weights(rng, C, False)
    x = torch.from_numpy(rng.randn(1, L, C).astype(np.float32))
    plan = _plan(L, False, B=1)
    want = mrf.fused_mrf_plain(x, weights, KERNEL_SIZES, DILATIONS)
    # the same rows followed by a window of zeros that counts as sequence:
    # inside the tile nothing past row L is masked any more
    long_x = torch.cat([x, torch.zeros(1, plan.win, C)], dim=1)
    got = mrf.fused_mrf_tiled(long_x, weights, KERNEL_SIZES, DILATIONS, plan)[:, :L]
    assert (got - want).abs().max().item() > 1e-3


def test_tile_schedule_matches_pallas_interpret():
    """The schedule against the TPU kernel itself (interpret mode), at the
    float32 bar of tests/test_torch_mrf.py (2e-5 of the output scale)."""
    rng = np.random.RandomState(5)
    kernel_sizes, dilations = (3, 7), ((1, 3, 5), (1, 3))
    L = 160  # JAX packs 4 steps of 32 channels a row and tiles rows by 8
    weights = _weights(rng, C, False, kernel_sizes, dilations)
    x = rng.randn(1, L, C).astype(np.float32)
    want = np.asarray(jax_fused_mrf(
        jnp.asarray(x), [tuple(jnp.asarray(t.numpy()) for t in blk) for blk in weights],
        kernel_sizes, dilations, compute_dtype=jnp.float32, interpret=True,
    ))
    plan = mrf.plan_fused("bf16", C, kernel_sizes, dilations, False, 1, L, 132)
    got = mrf.fused_mrf_tiled(torch.from_numpy(x), weights, kernel_sizes, dilations, plan).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale)


# ---------------------------------------------------------------------------
# The launch plan.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["bf16", "int8"])
@pytest.mark.parametrize("sms", [86, 100, 114, 128, 132])
@pytest.mark.parametrize("B", [1, 2, 64])
def test_plan_fits_every_h100_at_every_default_stage(route, sms, B):
    """Every fused MRF stage of ``Config()`` (C = 64 and 32) plans within a
    block's 232,448 bytes on every H100 from 86 SMs up, at 1 to 768 mel
    frames: windows the kernel takes (``fused_windows``: a multiple of 8,
    of 16 past one TMA box, at most 512 rows), tiles of 64 rows or more
    covering L, one launch for the stage; C = 256 and 128 take the
    per-conv pipeline."""
    h = Config().hifigan
    resblock2 = h.resblock != "1"
    for frames in (1, 37, 128, 512, 768):
        for C_in, width, _, u, L_in, _ in flops.stage_shapes(h, frames):
            p = mrf.plan_fused(route, width, h.resblock_kernel_sizes, h.resblock_dilation_sizes,
                               resblock2, B, L_in * u, sms)
            if width > 64:
                assert p is None
                continue
            halo = max(mrf.fused_halo(k, d, resblock2) for k, d in zip(
                h.resblock_kernel_sizes, h.resblock_dilation_sizes))
            assert p.n_res == 3 and p.halo == halo and p.win == p.bm + 2 * halo
            assert p.win in mrf.fused_windows() and p.win % 8 == 0 and (p.win <= 256 or p.win % 16 == 0)
            assert p.bm >= mrf.FUSED_BLOCK and p.win <= 512
            assert p.smem_bytes <= mrf.SMEM_LIMIT == 232_448
            assert mrf.FUSED_MIN_STAGES <= p.stages <= mrf.FUSED_MAX_STAGES
            assert (p.tiles_per_row - 1) * p.bm < L_in * u <= p.tiles_per_row * p.bm
            assert 1 <= p.ctas <= min(sms, B * p.tiles_per_row)


def test_plan_takes_the_routes_and_widths_that_won():
    """The fused pipeline takes the bf16 and static int8 stages at the
    widths of ``FUSED_CHANNELS`` (32 and 64); other widths, the float32
    route and dynamic int8 scales take the per-conv pipeline."""
    for route in ("bf16", "int8"):
        for width in (16, 32, 48, 64, 96, 128, 256):
            plan = mrf.plan_fused(route, width, KERNEL_SIZES, DILATIONS, False, 1, 1000, 132)
            assert (plan is not None) == (width in mrf.FUSED_CHANNELS == (32, 64))
    assert mrf.plan_fused("tf32", 32, KERNEL_SIZES, DILATIONS, False, 1, 1000, 132) is None
    assert mrf.fused_route(torch.bfloat16, True, None) is None
    assert mrf.fused_route(torch.bfloat16, True, torch.ones(3)) == "int8"
    assert mrf.fused_route(torch.bfloat16, False, None) == "bf16"
    assert mrf.fused_route(torch.float32, False, None) is None


def test_plan_picks_the_window_that_issues_the_fewest_rows():
    """Of the (ring, window) pairs that fit, the plan takes the one whose
    busiest block computes the fewest rows, worked out by hand.  At B=64,
    768 frames (hundreds of tiles a block) that is the fewest rows per
    output row: bf16 C = 32 a 496-row window (bm = 376, a 3-slot ring of 16
    KB: 256 + 3 * 16,384 + 496 * 32 * 6 + 376 * 32 * 4 = 192,768 bytes), C
    = 64 352 rows beside a 2-slot ring (256 + 32,768 + 352 * 64 * 6 + 232 *
    64 * 4 = 227,584), int8 C = 64 368 rows (3 slots: 256 + 49,152 + 368 *
    64 * 5 + 248 * 64 * 4 = 230,656).  At B=2, 128 frames bf16 C = 64 (L =
    16,384) the 352-row window's 71 tiles a row make 142 tiles, two waves
    on 132 SMs of 82 blocks a tile; a 248-row window (bm = 128) makes 256
    tiles, also two waves, of 55 blocks."""
    p = mrf.plan_fused("bf16", 32, KERNEL_SIZES, DILATIONS, False, B=64, L=768 * 256, sms=132)
    assert (p.stages, p.win, p.bm, p.smem_bytes) == (3, 496, 376, 192_768)
    p = mrf.plan_fused("bf16", 64, KERNEL_SIZES, DILATIONS, False, B=64, L=768 * 128, sms=132)
    assert (p.stages, p.win, p.bm, p.smem_bytes) == (2, 352, 232, 227_584)
    p = mrf.plan_fused("int8", 64, KERNEL_SIZES, DILATIONS, False, B=64, L=768 * 128, sms=132)
    assert (p.stages, p.win, p.bm, p.smem_bytes) == (3, 368, 248, 230_656)
    p = mrf.plan_fused("bf16", 64, KERNEL_SIZES, DILATIONS, False, B=2, L=128 * 128, sms=132)
    assert (p.win, p.bm, p.tiles_per_row, p.ctas) == (248, 128, 128, 132)
    assert [mrf.fused_block_rows(w, 60, k, (1, 3, 5), False) // 64 for w in (352, 248) for k in KERNEL_SIZES] == [
        24, 28, 30, 17, 18, 20]
    # rows a 496-row tile computes (halo 60): k = 3 takes 7, 7, 7, 7, 6, 6
    # blocks of 64 rows for its six convs (ranges 398, 396, 390, 388, 378,
    # 376), k = 7 7, 7, 7, 7, 6, 6, k = 11 8, 8, 7, 7, 7, 6
    assert [mrf.fused_block_rows(496, 60, k, (1, 3, 5), False) for k in KERNEL_SIZES] == [40 * 64, 40 * 64, 43 * 64]


def _source():
    return (_build.CSRC_DIR / "mrf_fused.cuh").read_text()


def test_plan_mirrors_the_kernel_source():
    """The constants, route traits and formulas that ``plan_fused`` copies
    from csrc/mrf_fused.cuh (slot bytes, shared memory) agree with the
    source, so a drift fails here and not only as a refused launch on the
    card."""
    src = _source()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (FUSED_\w+) = (\d+);", src)}
    stages = re.search(r"constexpr int FUSED_MIN_STAGES = (\d+), FUSED_MAX_STAGES = (\d+);", src)
    names = ("FUSED_BOX", "FUSED_BLOCK", "FUSED_MAX_BLOCKS", "FUSED_MAX_RES", "FUSED_MAX_UNITS",
             "FUSED_RES_FIELDS", "FUSED_SLOT_BYTES")
    assert {k: consts[k] for k in names} == {k: getattr(mrf, k) for k in names}
    assert consts["FUSED_WARPS"] == 8
    assert (int(stages.group(1)), int(stages.group(2))) == (mrf.FUSED_MIN_STAGES, mrf.FUSED_MAX_STAGES)
    traits = {r: tuple(int(v) for v in vals) for r, *vals in re.findall(
        r"struct FusedTraits<FRoute::k(\w+)> \{\s*static constexpr int OP = (\d+), WE = (\d+), KSTEP", src)}
    assert traits == {"Bf16": mrf.FUSED_TRAITS["bf16"], "Int8": mrf.FUSED_TRAITS["int8"]}
    assert "(C != 32 && C != 64)" in src and mrf.FUSED_CHANNELS == (32, 64)

    def c_body(signature):
        body = re.search(re.escape(signature) + r" \{\s*return (.*?);\n", src, re.S).group(1)
        return " ".join(body.split()).replace("(size_t)", "").replace("/", "//")

    slot = c_body("constexpr int fused_slot_bytes(int we, int C)")
    smem = c_body("inline size_t fused_smem_bytes(int op, int slot, int C, int win, int bm, int stages)")
    for route, (op, we) in mrf.FUSED_TRAITS.items():
        for width, win, bm, st in [(32, 496, 376, 3), (64, 352, 232, 2), (64, 184, 64, 4)]:
            s_bytes = eval(slot, dict(we=we, C=width, FUSED_SLOT_BYTES=mrf.FUSED_SLOT_BYTES))
            assert s_bytes == mrf.fused_slot_bytes(route, width) == 16384
            c_val = eval(smem, dict(op=op, slot=s_bytes, C=width, win=win, bm=bm, stages=st))
            assert c_val == mrf.fused_smem_bytes(route, width, win, bm, st)


# ---------------------------------------------------------------------------
# The MACs the fused stages compute.
# ---------------------------------------------------------------------------

# MACs the fused kernel issues for the MRF convs of a default stage at B=2,
# 128 mel frames, worked out by hand from the plan's tile and the 64-row
# blocks each conv's range takes (halo 60; a conv's range shrinks by (k-1)/2
# * d a side, from [60 - halo_k, win - 60 + halo_k)):
# C = 32 (L = 32,768): 125 tiles a row of bm = 264 in 384-row windows;
# k = 3 takes 5 blocks for each of its six convs (ranges 286 ... 264),
# k = 7 6, 6, 5, 5, 5, 5 (330, 324, 306, 300, 270, 264), k = 11 6, 6, 6,
# 6, 5, 5 (374, 364, 334, 324, 274, 264): 2 * 125 * (30 * 64 * 3 + 32 * 64
# * 7 + 34 * 64 * 11) * 32 * 32, the same for bf16 and int8.
# C = 64 (L = 16,384), bf16: 128 tiles of bm = 128 in 248-row windows;
# k = 3 3, 3, 3, 3, 3, 2 (150 ... 128), k = 7 4, 3, 3, 3, 3, 2 (194, 188,
# 170, 164, 134, 128), k = 11 4, 4, 4, 3, 3, 2 (238, 228, 198, 188, 138,
# 128): 2 * 128 * (17 * 64 * 3 + 18 * 64 * 7 + 20 * 64 * 11) * 64 * 64.
# int8 (its smaller row buffer fits a 384-row window beside a 2-slot
# ring): 63 tiles of 264, the blocks of C = 32: 2 * 63 * (30 * 64 * 3 + 32 *
# 64 * 7 + 34 * 64 * 11) * 64 * 64.
MACS_BY_HAND = {
    ("bf16", 32): 11_272_192_000, ("int8", 32): 11_272_192_000,
    ("bf16", 64): 26_642_219_008, ("int8", 64): 22_724_739_072,
}


@pytest.mark.parametrize("route,width", sorted(MACS_BY_HAND))
def test_issued_macs_of_the_fused_stages_by_hand(route, width):
    """``fused_issued_macs`` of the plan for a default stage at B=2, 128
    mel frames, against the count worked out by hand."""
    h = Config().hifigan
    ks, ds = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    L = 128 * 64 * 128 // width
    plan = mrf.plan_fused(route, width, ks, ds, False, 2, L, 132)
    assert (plan.win, plan.tiles_per_row) == {32: (384, 125), 64: (248 if route == "bf16" else 384, 128 if route == "bf16" else 63)}[width]
    assert flops.fused_issued_macs(plan, width, ks, ds, False, 2) == MACS_BY_HAND[(route, width)]
    assert flops.mrf_issued_flops(h, 2, L, width, {"bf16": "bfloat16", "int8": "int8"}[route], 132,
                                  int8_static=True) == 2 * MACS_BY_HAND[(route, width)]


@pytest.mark.parametrize("route", ["bf16", "int8"])
@pytest.mark.parametrize("B,frames", [(1, 512), (2, 128), (64, 768)])
def test_issued_macs_of_the_fused_stages(route, B, frames):
    """The fused stages of the default generator compute at least the
    analytic MACs and at most 1.6x of them (the halo recompute and the
    64-row blocks: windows of up to 496 rows, narrower where a wider one
    would leave the grid's last wave short)."""
    h = Config().hifigan
    ks, ds = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    for _, width, _, u, L_in, _ in flops.stage_shapes(h, frames):
        L = L_in * u
        plan = mrf.plan_fused(route, width, ks, ds, False, B, L, 132)
        if plan is None:
            assert width not in mrf.FUSED_CHANNELS
            continue
        issued = flops.fused_issued_macs(plan, width, ks, ds, False, B)
        analytic = flops.mrf_flop(h, B, L, width, False) / 2
        assert analytic <= issued <= 1.6 * analytic


def test_generator_issued_flops_count_the_fused_stages():
    """The generator's issued count is the per-conv count of stage 0 and
    the prologues plus the fused stages' blocks; int8 counts them only with
    static scales (dynamic scales take the per-conv pipeline)."""
    cfg = Config()
    h = cfg.hifigan
    ks, ds = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    B, frames = 2, 128
    fused = 0
    analytic_mrf = 0
    for _, width, _, u, L_in, _ in flops.stage_shapes(h, frames)[1:]:
        plan = mrf.plan_fused("bf16", width, ks, ds, False, B, L_in * u, 132)
        if plan is None:  # the per-conv pipeline, counted as needed here (its rows divide its tiles)
            continue
        fused += flops.fused_issued_macs(plan, width, ks, ds, False, B)
        analytic_mrf += flops.mrf_flop(h, B, L_in * u, width, False) / 2
    analytic = flops.generator_flops(cfg, frames, B)
    assert flops.generator_issued_flops(cfg, frames, B, "bfloat16") == analytic + 2 * (fused - analytic_mrf)
    dynamic = flops.generator_issued_flops(cfg, frames, B, "int8")
    static = flops.generator_issued_flops(cfg, frames, B, "int8", int8_static=True)
    assert static > dynamic >= analytic
