"""The port's FLOP accounting (``viettts_tpu_torch/utils/flops.py``) against
the JAX package's ``viettts_tpu/utils/flops.py``, and its H100 peaks, MFU
report and issued-MAC count.

Bars: the analytic counts exactly equal (integers); the issued count
exactly equal to the analytic one where every dimension divides its tile,
never below it elsewhere; the peaks and the moved bounds as the H100 SXM
data sheet and PERF.md state them, to 3 significant digits.
"""

import re

import pytest

from viettts_tpu.config import Config as JaxConfig, HifiGanConfig as JaxHifiGanConfig
from viettts_tpu.utils import flops as jax_flops
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.ops import mrf
from viettts_tpu_torch.utils import flops
from tests.test_torch_mrf_fused import MACS_BY_HAND
from tests.test_torch_pipeline import port_config

CONFIGS = {
    "default": JaxConfig(),
    "resblock2": JaxConfig(hifigan=JaxHifiGanConfig(
        resblock="2", upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=256,
        resblock_kernel_sizes=(3, 5, 7), resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))),
}
SHAPES = [(1, 7, 23), (1, 64, 158), (4, 40, 300), (3, 256, 1024)]  # (batch, tokens, frames)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch,tokens,frames", SHAPES)
def test_counts_equal_jax(name, batch, tokens, frames):
    jcfg = CONFIGS[name]
    cfg = port_config(jcfg)
    assert flops.duration_flops(cfg, tokens, batch) == jax_flops.duration_flops(jcfg, tokens, batch)
    assert flops.acoustic_decode_flops(cfg, tokens, frames, batch) == jax_flops.acoustic_decode_flops(
        jcfg, tokens, frames, batch)
    assert flops.generator_flops(cfg, frames, batch) == jax_flops.generator_flops(jcfg, frames, batch)
    assert flops.generator_flops(cfg.hifigan, frames, batch) == jax_flops.generator_flops(jcfg.hifigan, frames, batch)
    got = flops.pipeline_flops(cfg, tokens, frames, batch)
    assert got == jax_flops.pipeline_flops(jcfg, tokens, frames, batch) and isinstance(got, int)


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 495e12, 67e12, 1979e12, 67e12, 3.35e12, 132)),
    ("NVIDIA H100 PCIe", (756e12, 378e12, 51e12, 1513e12, 51e12, 2.0e12, 114)),
])
def test_device_peaks_of_known_cards(name, want, monkeypatch):
    """``device_peaks`` reads ``torch.cuda.get_device_name``: the data
    sheets' dense bf16, TF32, float32, int8 and FP64-tensor rates, HBM
    bytes/s and SM count."""
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    got = flops.device_peaks()
    assert (got.bf16, got.tf32, got.fp32, got.int8, got.fp64_tensor, got.hbm_bytes_per_s, got.sm_count) == want
    assert flops.peaks_for_name(name) == got


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H200", "Tesla T4", "TPU v5 lite", ""])
def test_device_peaks_refuse_unknown_cards(name, monkeypatch):
    """No fallback: an unknown card raises (JAX's falls back to v5e)."""
    import torch

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
    with pytest.raises(ValueError, match="no peaks known"):
        flops.device_peaks()


def test_mfu_report_keys_do_not_depend_on_the_dtype():
    """One key, ``mfu``, against the route's compute peak, which
    ``mfu_peak`` names (JAX renames the key by dtype,
    ``viettts_tpu/utils/flops.py:240-243``)."""
    peaks = flops.H100_SXM
    reports = {d: flops.mfu_report(1e12, 1e-3, compute_dtype=d, peaks=peaks) for d in ("bf16", "float32", "int8")}
    keys = {d: sorted(r) for d, r in reports.items()}
    assert keys["bf16"] == keys["float32"] == keys["int8"]
    assert {d: r["mfu_peak"] for d, r in reports.items()} == {"bf16": "bf16", "float32": "tf32", "int8": "int8"}
    assert reports["bf16"]["tflops_per_sec"] == pytest.approx(1000.0)
    assert reports["bf16"]["mfu"] == pytest.approx(1e15 / 989e12)
    assert reports["float32"]["mfu"] == pytest.approx(1e15 / 495e12)
    assert reports["int8"]["mfu"] == pytest.approx(1e15 / 1979e12)


def test_kernel_plan_is_read_from_the_sources():
    """The tile table the count reads is the one ``launch_tile`` launches,
    and the chunk widths are the route traits' (a drift in ``csrc`` fails
    here)."""
    plan = flops.kernel_plan()
    src = (flops.CSRC / "mrf_common.cuh").read_text()
    switch = src[src.index("int launch_tile("):]
    launched = [(int(bm), int(bn)) for bm, bn in re.findall(r"case \d+: return launch_mma_conv<T, (\d+), (\d+),", switch)]
    assert [(t.bm, t.bn) for t in plan.tiles] == launched and len(launched) == 5
    assert plan.kc == {"bf16": 64, "tf32": 32, "int8": 64, "fp64": 16}
    assert plan.bf16_narrow[0] == 32 and sorted(plan.bf16_narrow[1]) == [2, 3, 4]
    assert plan.int8_narrow == (32, 2, (32, 128, 32))
    assert (plan.post_rows, plan.post_chunk, plan.warps_per_sm, plan.narrow_bn) == (256, 32, 8, 32)
    assert plan.fused_block == mrf.FUSED_BLOCK == 64


def _fused_excess(cfg, frames, batch, route, sm_count=flops.H100_SXM.sm_count, resblock2=False):
    """2 x (MACs the fused stages compute - the MACs they need): the halo
    recompute and the 64-row blocks of ``csrc/mrf_fused.cuh``."""
    h = cfg.hifigan
    ks, ds = h.resblock_kernel_sizes, h.resblock_dilation_sizes
    excess = 0
    for _, width, _, u, L_in, _ in flops.stage_shapes(h, frames):
        launch = mrf.plan_fused(route, width, ks, ds, resblock2, batch, L_in * u, sm_count)
        if launch is not None:
            excess += 2 * flops.fused_issued_macs(launch, width, ks, ds, resblock2, batch)
            excess -= flops.mrf_flop(h, batch, L_in * u, width, resblock2)
    return excess


@pytest.mark.parametrize("route", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("batch", [1, 2, 4])
def test_issued_flops_equal_analytic_where_tiles_divide(route, batch):
    """128 mel frames of the default generator: every stage's rows divide
    every tile's 128, its channels the chunks (int8's 32-channel stage
    excepted where K3 takes 64-channel chunks), conv_post's rows its 256.
    The bf16 route's fused stages (C = 32 and 64) add their halo recompute
    and 64-row blocks: at B=2 the counts worked out by hand in
    tests/test_torch_mrf_fused.py."""
    cfg = Config()
    issued = flops.generator_issued_flops(cfg, 128, batch, route)
    analytic = flops.generator_flops(cfg, 128, batch)
    if route == "float32":
        assert issued == analytic
    elif route == "bfloat16":
        assert issued == analytic + _fused_excess(cfg, 128, batch, "bf16")
        assert issued > analytic
        if batch == 2:
            h = cfg.hifigan
            needed = sum(flops.mrf_flop(h, 2, 128 * 64 * 128 // c, c, False) for c in (32, 64))
            by_hand = MACS_BY_HAND[("bf16", 32)] + MACS_BY_HAND[("bf16", 64)]
            assert issued == analytic + 2 * by_hand - needed
    else:  # the last stage's 32 channels padded to a 64-channel chunk where the tile is not the narrow one
        plan = flops.kernel_plan()
        tile = flops.pick_tile(plan, batch, 128 * 256, 32, flops.H100_SXM.sm_count)
        assert (issued == analytic) == (tile == plan.int8_narrow[1])
        assert issued >= analytic


@pytest.mark.parametrize("route", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("batch,frames", [(1, 158), (2, 100), (4, 301), (1, 7)])
@pytest.mark.parametrize("sm_count", [132, 114])
def test_issued_flops_at_least_analytic(route, batch, frames, sm_count):
    cfg = Config()
    issued = flops.generator_issued_flops(cfg, frames, batch, route, sm_count=sm_count)
    assert issued >= flops.generator_flops(cfg, frames, batch)
    # padded rows and the fused stages' halo recompute (at most 1.6x a
    # stage's MACs, tests/test_torch_mrf_fused.py)
    assert issued < 3 * flops.generator_flops(cfg, frames, batch)


def test_issued_flops_of_resblock2_on_divisible_shapes():
    cfg = port_config(CONFIGS["resblock2"])
    issued = flops.generator_issued_flops(cfg, 256, 2, "bfloat16")
    assert issued == flops.generator_flops(cfg, 256, 2) + _fused_excess(cfg, 256, 2, "bf16", resblock2=True)


def test_training_step_counts_and_kernel_bounds():
    """The counts and bounds moved here from ``chip_smoke.py``, at the
    values PERF.md records for the default widths on the H100 SXM: a
    duration step 0.174 TFLOP, an acoustic step 3.492 TFLOP, a GAN step
    13.752 TFLOP (B=64); K1 at B=1, 512 frames 0.0667 ms; the four K2
    stages at B=2, 128 frames 0.159 ms bf16 and 0.952 ms float32; K3
    0.149 ms."""
    cfg, peaks = Config(), flops.H100_SXM
    assert round(flops.duration_step_flop(cfg) / 1e12, 3) == 0.174
    assert round(flops.acoustic_step_flop(cfg) / 1e12, 3) == 3.492
    assert round(flops.gan_step_flop(cfg) / 1e12, 3) == 13.752
    ms, by = flops.ar_decode_bound(1, 512, 512, 256, 80, peaks)
    assert (round(ms, 4), by) == (0.0667, "operations")
    h = cfg.hifigan
    assert [round(flops.mrf_bound(h, 2, 128, r, peaks)[0], 3) for r in ("bfloat16", "float32", "int8")] == [
        0.159, 0.952, 0.149]
    assert flops.stage_shapes(h, 128)[0] == (512, 256, 16, 8, 128, False)
    assert flops.mrf_flop(h, 1, 10, 4, resblock2=False) == 2.0 * 10 * 16 * 2 * (3 + 7 + 11) * 3


def test_a_narrower_card_is_counted_with_its_own_tiles():
    """Fewer SMs can pick a larger tile (fewer blocks needed to fill the
    card), so the padding, and with it the issued count, follow the card:
    the per-conv stages pad more, the fused stages recompute less halo."""
    cfg = Config()
    counts = {sm: flops.generator_issued_flops(cfg, 37, 1, "bfloat16", sm_count=sm) for sm in (132, 114, 16)}
    excess = {sm: _fused_excess(cfg, 37, 1, "bf16", sm) for sm in counts}
    assert excess[16] < excess[114] <= excess[132]
    per_conv = {sm: counts[sm] - excess[sm] for sm in counts}
    assert per_conv[16] >= per_conv[114] >= per_conv[132] >= flops.generator_flops(cfg, 37)
