"""Kernel K1's plain twin (``ar_decode_plain``) against the JAX Pallas
``ar_decode`` in interpret mode, with the same numpy keep-masks fed to
both, and the CPU dispatch of the ``ar_decode`` wrapper."""

import re
from pathlib import Path

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


def _fan_in_noise(tree, rng):
    """Seeded noise in place of every leaf of a shape tree (from
    ``jax.eval_shape``), each matrix scaled by 1/sqrt(its rows) so that a
    1024-unit decoder's sums stay of order one; BatchNorm variances stay
    positive."""

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, f) for f, v in zip(node._fields, node)))
        scale = 0.5 / np.sqrt(np.prod(node.shape[:-1])) if len(node.shape) > 1 else 0.1
        noise = (rng.randn(*node.shape) * scale).astype(np.float32)
        return np.abs(noise) + 0.5 if key == "var" else noise

    return walk(tree)


def test_acoustic_inference_at_tacotron2_width_matches_pallas_interpret():
    """The port's ``AcousticModel.inference`` at Tacotron 2's decoder width
    (``decoder_dim`` = 1024, the width K1 now plans by streaming part of
    its gate columns; other widths tiny, 8 frames, dropout off) against
    the JAX model's Pallas decode in interpret mode, weights carried across
    by the checkpoint converter: atol 5e-5, the bar of
    ``test_plain_twin_matches_pallas_interpret``."""
    import jax

    from viettts_tpu.config import AcousticModelConfig
    from viettts_tpu.models import AcousticModel
    from viettts_tpu.types import AcousticBatch
    from viettts_tpu_torch import checkpoint as ckpt
    from viettts_tpu_torch.models.acoustic import AcousticModel as TorchAcoustic

    rng = np.random.RandomState(3)
    cfg = AcousticModelConfig(vocab_size=24, encoder_dim=16, decoder_dim=1024, prenet_dim=8, postnet_dim=8,
                              prenet_dropout_at_inference=False)
    B, T, NF = 2, 4, 8
    lengths = np.asarray([4, 3])
    toks = rng.randint(1, 24, (B, T)).astype(np.int64)
    toks[1, 3:] = 0
    durs = np.asarray([[2, 2, 3, 1], [3, 2, 3, 0]], np.float32)
    model = AcousticModel(cfg)
    batch = AcousticBatch(jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(durs), None, None,
                          jnp.zeros((B, NF, 80)))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "prenet", "zoneout"))}
    variables = _fan_in_noise(dict(jax.eval_shape(lambda: model.init(rngs, batch, train=True))), rng)
    want = np.asarray(model.apply(variables, jnp.asarray(toks), jnp.asarray(durs), NF, jnp.asarray(lengths),
                                  use_pallas=True, method=AcousticModel.inference))

    port = TorchAcoustic(cfg)
    ckpt.load_acoustic(port, variables)
    plain = ar_decoder.ar_decode.plain_calls
    with torch.no_grad():
        got = port.eval().inference(torch.from_numpy(toks), torch.from_numpy(durs), NF,
                                    torch.from_numpy(lengths)).numpy()
    assert ar_decoder.ar_decode.plain_calls == plain + 1
    assert got.shape == want.shape == (B, NF, 80)
    assert np.abs(want).max() > 0.1
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


def test_plan_decode_published_width():
    """H=512, P=256, D=80 on an H100 (132 SMs): 128 CTAs of 4 hidden units,
    every gate column of both layers resident within 227 KB per CTA."""
    plan = ar_decoder.plan_decode(512, 256, 80, 132)
    assert (plan.ctas, plan.units, plan.prenet_cols, plan.proj_cols) == (128, 4, 2, 1)
    assert (plan.groups, plan.streamed) == (1, 0)
    resident = 4 * (2 * 256 + 3 * 512) * 4 * plan.units  # the five gate-column blocks
    assert resident == 131072 and resident < plan.smem_bytes <= ar_decoder.SMEM_LIMIT


# the plans of the parent design (every gate block resident, one column group)
# at H=512, P=256, D=80: (ctas, units, prenet_cols, proj_cols, stage, rows, smem_bytes)
RESIDENT_PLANS_512 = {
    (132, 1): (128, 4, 2, 1, 1, 1, 142436), (132, 4): (128, 4, 2, 1, 4, 4, 155396),
    (132, 16): (128, 4, 2, 1, 16, 16, 207236), (132, 64): (128, 4, 2, 1, 16, 64, 214916),
    (114, 1): (103, 5, 4, 1, 1, 1, 177956), (114, 4): (103, 5, 4, 1, 4, 4, 191076),
    (114, 16): (103, 5, 4, 1, 8, 16, 210180), (114, 64): (103, 5, 4, 1, 8, 64, 219780),
}


@pytest.mark.parametrize("sms,rows", sorted(RESIDENT_PLANS_512))
def test_plan_decode_at_512_streams_nothing(sms, rows):
    """The published width keeps the resident design: the same plan as
    before wide decoders were planned, one column group, nothing streamed."""
    want = ar_decoder.DecodePlan(*RESIDENT_PLANS_512[sms, rows])
    assert ar_decoder.plan_decode(512, 256, 80, sms, rows) == want
    assert (want.groups, want.streamed) == (1, 0)


@pytest.mark.parametrize(
    "H,P,D,sms",
    [(64, 32, 20, 132), (96, 48, 80, 132), (270, 40, 24, 132), (512, 256, 80, 132), (512, 256, 80, 128), (32, 8, 16, 132)],
)
def test_plan_decode_covers_every_column(H, P, D, sms):
    """At most one CTA per SM; the units, prenet and projection columns of
    the CTAs cover H, P and D, the last CTA non-empty; prenet and
    projection counts are powers of two; one output per thread."""
    plan = ar_decoder.plan_decode(H, P, D, sms)
    assert plan.ctas <= sms
    assert (plan.ctas - 1) * plan.units < H <= plan.ctas * plan.units
    assert plan.ctas * plan.prenet_cols >= P and plan.ctas * plan.proj_cols >= D
    for n in (plan.prenet_cols, plan.proj_cols):
        assert n & (n - 1) == 0
    assert 1 <= plan.units <= ar_decoder.MAX_UNITS
    assert plan.stage * max(4 * plan.units, plan.prenet_cols, plan.proj_cols) <= ar_decoder.THREADS
    assert plan.smem_bytes <= ar_decoder.SMEM_LIMIT


def _check_wide_plan(plan, H, P, D, sms, rows):
    """What every plan must hold: the grid covers H (the last CTA non-empty)
    and P and D within ``sms`` CTAs, equal column groups of at most
    MAX_UNITS units, one output per thread, the shared memory its formula
    gives within the limit, and the gate blocks split into resident and
    streamed rows that add up to all of them."""
    assert plan.ctas <= sms and plan.rows == rows
    assert (plan.ctas - 1) * plan.units < H <= plan.ctas * plan.units
    assert plan.ctas * plan.prenet_cols >= P and plan.ctas * plan.proj_cols >= D
    assert plan.units == plan.groups * plan.group_units and 1 <= plan.group_units <= ar_decoder.MAX_UNITS
    assert plan.stage * max(4 * plan.group_units, plan.prenet_cols, plan.proj_cols) <= ar_decoder.THREADS
    assert plan.smem_bytes == 4 * ar_decoder.smem_floats(H, P, D, plan.group_units, plan.groups, plan.prenet_cols,
                                                         plan.proj_cols, plan.stage, rows, plan.streamed)
    assert plan.smem_bytes <= ar_decoder.SMEM_LIMIT
    resident = ar_decoder.block_rows(P, H, ar_decoder.ALL_BLOCKS - plan.streamed)
    streamed = ar_decoder.block_rows(P, H, plan.streamed)
    assert resident + streamed == 2 * P + 3 * H
    assert plan.streamed_floats(P, H) == plan.ctas * 4 * plan.units * streamed
    return resident, streamed


@pytest.mark.parametrize("rows", [1, 64])
@pytest.mark.parametrize("sms", [86, 114, 132])
@pytest.mark.parametrize("H", [640, 768, 1024, 1536, 2048])
def test_plan_decode_plans_wide_decoders(H, sms, rows):
    """Decoder widths whose float32 gate columns exceed the card's shared
    memory (Tacotron 2's 1024) plan on every H100-class SM count, for one
    row and for 64: the gate blocks that do not fit are streamed.  From
    H=768 up nothing fits whole on any of these cards, so every plan
    streams; at 1024 on 132 SMs and one row the chain's blocks (W1p, W2h1)
    stay resident and two of the three others stream; at 2048 even the
    chain's W2h1 streams."""
    plan = ar_decoder.plan_decode(H, 256, 80, sms, rows)
    resident, streamed = _check_wide_plan(plan, H, 256, 80, sms, rows)
    if H >= 768:
        assert streamed > 0 and plan.streamed_bytes_per_frame(256, H) > 0
    if (H, sms, rows) == (1024, 132, 1):
        assert (plan.ctas, plan.units, plan.groups) == (128, 8, 2)
        assert [ar_decoder.GATE_BLOCKS[b] for b in range(5) if plan.streamed >> b & 1] == ["Wh1", "Wh2"]
    if H == 2048:
        assert plan.streamed & 0b00100  # W2h1, on the chain
    if plan.streamed & ar_decoder.CHAIN_BLOCKS == 0:
        assert resident >= 256 + H


@pytest.mark.parametrize("sms", range(114, 133))
def test_plan_decode_fits_every_h100(sms):
    """H=512, P=256, D=80 plans within the shared memory of a block on
    every H100 from 114 SMs (PCIe) to 132 (SXM), for 64 rows and for one:
    5 hidden units a CTA below 128 SMs (103 CTAs, the last holding 2), the
    SXM plan of 128 CTAs of 4 units from 128 on."""
    for rows in (ar_decoder.MAX_ROWS, 1):
        plan = ar_decoder.plan_decode(512, 256, 80, sms, rows)
        assert plan.smem_bytes <= ar_decoder.SMEM_LIMIT and plan.rows == rows
        want = (128, 4) if sms >= 128 else (103, 5)
        assert (plan.ctas, plan.units) == want


def _kernel_smem_floats():
    """``smem_floats`` of csrc/ar_decoder.cuh (with its helper
    ``block_rows``) as Python functions of (H, P, D, UG, NG, PK, DK, S, R,
    streamed) and (P, H, mask), and the kernel's integer ``constexpr``
    values."""
    src = (Path(ar_decoder.__file__).parent.parent / "csrc" / "ar_decoder.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}

    def parse(name):
        body = re.search(name + r"\(([^)]*)\) \{(.*?)\n\}", src, re.S)
        params = [p.split()[-1] for p in body.group(1).split(",")]
        stmts = " ".join(body.group(2).split()).replace("(size_t)", "").replace("const size_t ", "")
        return params, stmts.replace(", ncm =", "; ncm =").replace("return ", "value = ")

    def function(params, stmts, scope):
        def f(*args):
            local = dict(scope, **dict(zip(params, args)))
            for stmt in stmts.split(";"):
                exec(stmt.strip(), {}, local)
            return local["value"]

        return f

    block_rows = function(*parse(r"int block_rows"), {})
    floats = function(*parse(r"size_t smem_floats"),
                      dict(consts, kWarps=consts["kThreads"] // 32, max3=max, pad4=lambda n: (n + 3) // 4 * 4,
                           block_rows=block_rows))
    return consts, floats, block_rows


@pytest.mark.parametrize(
    "H,P,D,sms,rows",
    [(512, 256, 80, 132, 64), (512, 256, 80, 132, 1), (512, 256, 80, 114, 64), (512, 256, 80, 114, 4),
     (64, 32, 20, 132, 64), (96, 48, 80, 132, 64), (270, 40, 24, 132, 16), (512, 256, 80, 100, 64),
     (1024, 256, 80, 132, 1), (1024, 256, 80, 132, 64), (1024, 256, 80, 114, 4), (768, 256, 80, 132, 16),
     (640, 256, 80, 114, 64), (2048, 256, 80, 86, 16), (1536, 256, 80, 114, 1)],
)
def test_plan_decode_mirrors_the_kernel_source(H, P, D, sms, rows):
    """The constants and the shared-memory formula ``plan_decode`` copies
    from csrc/ar_decoder.cuh agree with the source, so a drift fails here
    and not only as a refused launch on the card."""
    consts, floats, block_rows = _kernel_smem_floats()
    assert {k: consts[k] for k in ("kThreads", "kStage", "kChunk", "kRows", "kMaxUnits", "kBlocks")} == {
        "kThreads": ar_decoder.THREADS, "kStage": ar_decoder.STAGE_ROWS,
        "kChunk": ar_decoder.BATCH_CHUNK, "kRows": ar_decoder.MAX_ROWS, "kMaxUnits": ar_decoder.MAX_UNITS,
        "kBlocks": len(ar_decoder.GATE_BLOCKS),
    }
    plan = ar_decoder.plan_decode(H, P, D, sms, rows)
    shape = (H, P, D, plan.group_units, plan.groups, plan.prenet_cols, plan.proj_cols, plan.stage, plan.rows,
             plan.streamed)
    assert plan.smem_bytes == 4 * floats(*shape) == 4 * ar_decoder.smem_floats(*shape)
    for mask in range(ar_decoder.ALL_BLOCKS + 1):
        assert block_rows(P, H, mask) == ar_decoder.block_rows(P, H, mask)


@pytest.mark.parametrize("H,sms", [(1024, 132), (2048, 132), (512, 85), (512, 64)])
def test_plan_decode_plans_what_the_resident_design_refused(H, sms):
    """H=1024 and 2048 on 132 SMs (8 and 16 units a CTA) and H=512 on 85
    SMs or fewer (7 units or more): the resident gate columns alone exceed
    a block's shared memory, which the resident design refused.  They now
    plan, for 64 rows and for one, in column groups of at most MAX_UNITS
    units with the blocks that do not fit streamed."""
    for rows in (ar_decoder.MAX_ROWS, 1):
        plan = ar_decoder.plan_decode(H, 256, 80, sms, rows)
        _check_wide_plan(plan, H, 256, 80, sms, rows)
        assert plan.groups >= 2 and plan.streamed


@pytest.mark.parametrize(
    "H,P,sms,rows,match",
    [
        (512, 256, 132, 0, "0 rows per launch"),
        (1024, 256, 132, ar_decoder.MAX_ROWS + 1, "65 rows per launch"),
        (8192, 256, 86, 64, "on 86 SMs needs .* bytes of shared memory per CTA .* with every gate block streamed"),
        (2048, 4096, 86, 1, "on 86 SMs needs 64 prenet and 1 projection columns per CTA"),
    ],
)
def test_plan_decode_refuses_what_does_not_fit(H, P, sms, rows, match):
    """What no plan holds: a launch of more rows than a CTA keeps gate sums
    and cell states for (or none); a CTA whose state rows and staged vector
    alone exceed a block's shared memory with every gate block streamed
    (H=8192 on 86 SMs at 64 rows); more prenet columns a CTA than two a
    warp.  The message names the SM count."""
    with pytest.raises(ValueError, match=match):
        ar_decoder.plan_decode(H, P, 80, sms, rows)
