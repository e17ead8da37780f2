"""The bi-LSTM's dispatch and the plan of its CUDA kernel, on the CPU.

``bidirectional_lstm`` launches ``csrc/lstm.cu`` only for float32 CUDA
tensors when no gradient is needed, and raises for any other call on CUDA
without one; where a gradient is needed, and on the CPU, it runs the loop
(``bidirectional_lstm_plain``) unchanged.  ``plan_lstm``
sizes the kernel's grid; its constants and shared-memory formula are
copies of the kernel source's, held to it here.  The kernel itself is held
to the loop on the card (``tests/test_torch_gpu.py``).
"""

import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from viettts_tpu_torch.ops import ar_decoder, rnn

SOURCE = Path(rnn.__file__).parent.parent / "csrc" / "lstm.cu"


def _params(rng, D, H):
    out = []
    for _ in range(2):
        p = rnn.LSTM(D, H)
        with torch.no_grad():
            for t in (p.w_i, p.w_h, p.b):
                t.copy_(torch.from_numpy((rng.randn(*t.shape) * 0.3).astype(np.float32)))
        out.append(p)
    return out


def _counts():
    return rnn.bidirectional_lstm.launches, rnn.bidirectional_lstm.plain_calls


def _fake(device="cuda", dtype=torch.float32, requires_grad=False):
    return SimpleNamespace(device=torch.device(device), dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize("grad_mode", [False, True])
@pytest.mark.parametrize(
    "case,engages_without_grad,engages_with_grad",
    [
        ("float32 cuda, nothing requires grad", True, True),
        ("a weight requires grad", True, False),
        ("the input requires grad", True, False),
        ("on the cpu", False, False),
        ("bfloat16 input", False, False),
        ("a float64 weight", False, False),
    ],
)
def test_kernel_engages_only_on_float32_cuda_without_grad(case, engages_without_grad, engages_with_grad, grad_mode):
    """The rule reads what the tensors show: their device, their dtype,
    and whether a gradient is needed (grad mode on and some tensor
    requiring one).  Stand-ins carry the attributes of CUDA tensors."""
    xs, weights = _fake(), [_fake() for _ in range(6)]
    if case == "a weight requires grad":
        weights[4] = _fake(requires_grad=True)
    elif case == "the input requires grad":
        xs = _fake(requires_grad=True)
    elif case == "on the cpu":
        xs = _fake(device="cpu")
    elif case == "bfloat16 input":
        xs = _fake(dtype=torch.bfloat16)
    elif case == "a float64 weight":
        weights[1] = _fake(dtype=torch.float64)
    with torch.set_grad_enabled(grad_mode):
        assert rnn.kernel_engages(xs, *weights) == (engages_with_grad if grad_mode else engages_without_grad)


@pytest.mark.parametrize("grad_mode", [False, True])
@pytest.mark.parametrize("case", ["bfloat16 input", "a float64 weight", "a weight on the cpu"])
def test_a_call_on_cuda_the_kernel_does_not_run_raises_without_grad(monkeypatch, case, grad_mode):
    """On CUDA with no gradient needed, a dtype other than float32 (or a
    weight elsewhere) raises with what it got, launching nothing and never
    falling back to the loop; where a gradient is needed the loop serves
    (the training route).  Stand-ins carry the attributes of CUDA tensors."""
    xs, weights = _fake(), [_fake(requires_grad=True) for _ in range(6)]
    if case == "bfloat16 input":
        xs = _fake(dtype=torch.bfloat16)
    elif case == "a float64 weight":
        weights[1] = _fake(dtype=torch.float64, requires_grad=True)
    else:
        weights[3] = _fake(device="cpu", requires_grad=True)
    fwd, bwd = (SimpleNamespace(w_i=w_i, w_h=w_h, b=b) for w_i, w_h, b in (weights[:3], weights[3:]))
    monkeypatch.setattr(rnn, "bidirectional_lstm_plain", lambda *args: "the loop")
    before = _counts()
    with torch.set_grad_enabled(grad_mode):
        if grad_mode:
            assert rnn.bidirectional_lstm(fwd, bwd, xs, None) == "the loop"
        else:
            with pytest.raises(ValueError, match="float32 CUDA tensors only") as refused:
                rnn.bidirectional_lstm(fwd, bwd, xs, None)
            want = {"bfloat16 input": "torch.bfloat16", "a float64 weight": "torch.float64",
                    "a weight on the cpu": "on cpu"}[case]
            assert want in str(refused.value)
    assert _counts() == before


@pytest.mark.parametrize("mode", ["inference", "grad", "float64"])
def test_the_cpu_takes_the_loop_and_counts_it(mode):
    """On the CPU every call runs the loop, in inference, under autograd
    and in float64: one plain call each, no launch, the loop's bits."""
    rng = np.random.RandomState(0)
    B, L, D, H = 3, 9, 5, 6
    fwd, bwd = _params(rng, D, H)
    xs = torch.from_numpy(rng.randn(B, L, D).astype(np.float32))
    lengths = torch.tensor([9, 4, 0])
    if mode == "float64":
        fwd, bwd, xs = fwd.double(), bwd.double(), xs.double()
    context = torch.enable_grad() if mode == "grad" else torch.inference_mode()
    before = _counts()
    with context:
        got = rnn.bidirectional_lstm(fwd, bwd, xs, lengths)
        want = rnn.bidirectional_lstm_plain(fwd, bwd, xs, lengths)
    assert _counts() == (before[0], before[1] + 2)
    assert torch.equal(got, want)
    assert got.requires_grad == (mode == "grad")


PLAN_WIDTHS = [1, 7, 32, 100, 250, 256, 384, 512]
PLAN_SMS = [86, 114, 132]
PLAN_ROWS = [1, 3, 16, 63, 64]


@pytest.mark.parametrize("sms", PLAN_SMS)
@pytest.mark.parametrize("H", PLAN_WIDTHS)
def test_plan_lstm_covers_every_width_on_every_card(H, sms):
    """Every H up to 512 plans on 86-132 SMs at every row count: slices of
    UNITS units cover H with the last one non-empty, both directions'
    row groups fit the SMs (a co-resident grid), no group is empty or
    takes more rows than it must, and the shared memory fits a block."""
    for rows in PLAN_ROWS:
        plan = rnn.plan_lstm(H, rows, sms)
        assert plan.slices * rnn.UNITS >= H > (plan.slices - 1) * rnn.UNITS
        assert plan.ctas == 2 * plan.groups * plan.slices <= sms
        assert plan.groups * plan.group_rows >= rows > (plan.groups - 1) * plan.group_rows
        assert plan.group_rows == -(-rows // min(rows, sms // (2 * plan.slices)))
        assert plan.smem_bytes == 4 * rnn.lstm_smem_floats(H, plan.group_rows) <= ar_decoder.SMEM_LIMIT


@pytest.mark.parametrize(
    "H,rows,sms,want",
    [
        (256, 64, 132, (128, 16, 4, 16)),  # the bulk cells' encoders: 4 row groups of 16 rows
        (256, 1, 132, (32, 16, 1, 1)),  # the stream's lead: one row, 16 CTAs a direction
        (256, 3, 132, (96, 16, 3, 1)),  # a row a group
        (256, 64, 114, (96, 16, 3, 22)),  # the H100 PCIe: 3 groups fit
        (512, 64, 132, (128, 32, 2, 32)),
        (512, 64, 86, (64, 32, 1, 64)),
        (32, 64, 132, (128, 2, 32, 2)),
    ],
)
def test_plan_lstm_grids(H, rows, sms, want):
    plan = rnn.plan_lstm(H, rows, sms)
    assert (plan.ctas, plan.slices, plan.groups, plan.group_rows) == want


@pytest.mark.parametrize(
    "H,rows,sms,match",
    [
        (513, 64, 132, "H=513"),
        (1024, 1, 132, "H=1024"),
        (0, 1, 132, "H=0"),
        (256, 0, 132, "0 rows per launch"),
        (256, 65, 132, "65 rows per launch"),
        (512, 1, 63, "needs 64 co-resident CTAs, the card has 63 SMs"),
    ],
)
def test_plan_lstm_refuses_what_it_does_not_plan(H, rows, sms, match):
    with pytest.raises(ValueError, match=match):
        rnn.plan_lstm(H, rows, sms)


def test_a_wider_lstm_on_cuda_raises_before_any_work(monkeypatch):
    """Above H=512 an inference call that would take the kernel raises
    with the width in its message (as K1's refusals do) and never falls
    back to the loop.  The device check is stood in for: this machine has
    no card."""
    monkeypatch.setattr(rnn, "kernel_engages", lambda *_: True)
    fwd, bwd = _params(np.random.RandomState(1), 4, 640)
    before = _counts()
    with torch.inference_mode(), pytest.raises(ValueError, match="H=640"):
        rnn.bidirectional_lstm(fwd, bwd, torch.zeros(2, 3, 4), torch.tensor([3, 2]))
    assert _counts() == before


def _kernel_source():
    """The kernel's integer ``constexpr`` values and ``smem_floats`` as a
    Python function of (H, group_rows)."""
    src = SOURCE.read_text()
    consts = {}
    for name, value in re.findall(r"constexpr int (k\w+) = ([^;]*);", src):  # in order; C's / on ints
        consts[name] = eval(value.replace("/", "//"), {}, dict(consts))
    body = re.search(r"size_t smem_floats\(int H, int group_rows\) \{\s*return (.*?);\n\}", src, re.S).group(1)
    expr = " ".join(body.split()).replace("(size_t)", "")

    def floats(H, group_rows):
        return eval(expr, {}, dict(consts, H=H, group_rows=group_rows, pad4=lambda n: (n + 3) // 4 * 4))

    return consts, floats


@pytest.mark.parametrize("H,group_rows", [(1, 1), (7, 3), (256, 16), (256, 1), (510, 22), (512, 64)])
def test_plan_mirrors_the_kernel_source(H, group_rows):
    """The constants and the shared-memory formula ``ops/rnn.py`` copies
    from csrc/lstm.cu agree with the source, so a drift fails here and
    not only as a refused launch on the card."""
    consts, floats = _kernel_source()
    assert {k: consts[k] for k in ("kThreads", "kUnits", "kPass", "kParts", "kMaxH", "kRows")} == {
        "kThreads": rnn.THREADS, "kUnits": rnn.UNITS, "kPass": rnn.PASS_ROWS, "kParts": rnn.PARTS,
        "kMaxH": rnn.MAX_H, "kRows": rnn.MAX_ROWS,
    }
    assert floats(H, group_rows) == rnn.lstm_smem_floats(H, group_rows)


def test_the_library_bi_lstm_chip_smoke_times_computes_the_loops_function():
    """``chip_smoke.py`` times cuDNN's ``nn.LSTM`` beside the kernel: gate
    columns permuted to (i, f, g, o), the forget gate's +1 in its bias, a
    packed sequence for the backward reset.  On the CPU that module gives
    the loop's outputs at every real position."""
    spec = importlib.util.spec_from_file_location("chip_smoke", SOURCE.parents[2] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.RandomState(5)
    B, T, D, H = 5, 11, 7, 12
    fwd, bwd = _params(rng, D, H)
    xs = torch.from_numpy(rng.randn(B, T, D).astype(np.float32))
    lengths = torch.tensor([T, 1, 5, 7, 3])
    library = chip_smoke.cudnn_bilstm([fwd, bwd], torch.device("cpu"))
    with torch.inference_mode():
        want = rnn.bidirectional_lstm_plain(fwd, bwd, xs, lengths)
        got = library(xs, lengths)
    real = torch.arange(T)[None, :, None] < lengths[:, None, None]
    torch.testing.assert_close(torch.where(real, got, want), want, rtol=0, atol=1e-5)
    assert not torch.allclose(torch.where(real, got, want)[:, :, H:], library.lstm(xs)[:, :, H:], atol=1e-3)
