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
    resident = 4 * (2 * 256 + 3 * 512) * 4 * plan.units  # the five gate-column blocks
    assert resident == 131072 and resident < plan.smem_bytes <= ar_decoder.SMEM_LIMIT


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
    """``smem_floats`` of csrc/ar_decoder.cu as a Python function of
    (H, P, D, U, PK, DK, S, R), and the kernel's integer ``constexpr`` values."""
    src = (Path(ar_decoder.__file__).parent.parent / "csrc" / "ar_decoder.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    body = re.search(r"size_t smem_floats\(([^)]*)\) \{(.*?)\n\}", src, re.S)
    params = [p.split()[-1] for p in body.group(1).split(",")]
    stmts = " ".join(body.group(2).split()).replace("(size_t)", "").replace("const size_t ", "")
    stmts = stmts.replace(", ncm =", "; ncm =").replace("return ", "floats = ")

    def floats(*args):
        scope = dict(consts, kWarps=consts["kThreads"] // 32, max3=max, pad4=lambda n: (n + 3) // 4 * 4,
                     **dict(zip(params, args)))
        for stmt in stmts.split(";"):
            exec(stmt.strip(), {}, scope)
        return scope["floats"]

    return consts, floats


@pytest.mark.parametrize(
    "H,P,D,sms,rows",
    [(512, 256, 80, 132, 64), (512, 256, 80, 132, 1), (512, 256, 80, 114, 64), (512, 256, 80, 114, 4),
     (64, 32, 20, 132, 64), (96, 48, 80, 132, 64), (270, 40, 24, 132, 16), (512, 256, 80, 100, 64)],
)
def test_plan_decode_mirrors_the_kernel_source(H, P, D, sms, rows):
    """The constants and the shared-memory formula ``plan_decode`` copies
    from csrc/ar_decoder.cu agree with the source, so a drift fails here
    and not only as a refused launch on the card."""
    consts, floats = _kernel_smem_floats()
    assert {k: consts[k] for k in ("kThreads", "kStage", "kChunk", "kRows", "kMaxUnits")} == {
        "kThreads": ar_decoder.THREADS, "kStage": ar_decoder.STAGE_ROWS,
        "kChunk": ar_decoder.BATCH_CHUNK, "kRows": ar_decoder.MAX_ROWS, "kMaxUnits": ar_decoder.MAX_UNITS,
    }
    plan = ar_decoder.plan_decode(H, P, D, sms, rows)
    assert plan.smem_bytes == 4 * floats(H, P, D, plan.units, plan.prenet_cols, plan.proj_cols,
                                         plan.stage, plan.rows)
    assert plan.smem_bytes == 4 * ar_decoder.smem_floats(H, P, D, plan.units, plan.prenet_cols,
                                                         plan.proj_cols, plan.stage, plan.rows)


@pytest.mark.parametrize("H,sms", [(1024, 132), (2048, 132), (512, 85), (512, 64)])
def test_plan_decode_refuses_what_does_not_fit(H, sms):
    """H=1024 on 132 SMs (8 units per CTA), or H=512 on 85 SMs or fewer (7
    units or more): the resident gate columns alone exceed a block's
    shared memory, for 64 rows and for one.  The message names the SM
    count."""
    for rows in (ar_decoder.MAX_ROWS, 1):
        with pytest.raises(ValueError, match=f"on {sms} SMs needs .* bytes of shared memory per CTA"):
            ar_decoder.plan_decode(H, 256, 80, sms, rows)
