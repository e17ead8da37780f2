"""The model modules a configuration names: the seeded trees are drawn as
they were before the models became modules, a new vocoder arrives as new
files only (its module and a configuration naming it), and the program's
configuration takes HiFi-GAN V3's tuple-of-tuple dilations."""

import copy
import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench.harness import cells, core
from perfbench.harness.flops import H100_SXM, bound_seconds
from perfbench.harness.weights import seeded_trees
from tiny import TINY

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _digest(trees) -> str:
    h = hashlib.sha256()

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                h.update("/".join(path + (k,)).encode() + repr(v.shape).encode() + str(v.dtype).encode())
                h.update(v.tobytes())

    walk(trees, ())
    return h.hexdigest()


# the trees' SHA-256 at seed 2**31 + 3, as the harness drew them before the model modules
@pytest.mark.parametrize("name,tiny,digest", [
    ("viettts-infore", False, "c6de24de0d5615dd8c51c3063312f129ae44afee8b24947a42c72a1c98305b5a"),
    ("viettts-infore", True, "498ed9dbbb17f76641da5d4ed7ecfefa1c5735c88e2416382eb68637ed9df95d"),
    ("tacotron2-hifigan-v1", False, "f18b3fd20406a1e3f2fac1e7aa1121405b6e8af9c93e8c23c605717516a0ac30"),
    ("tacotron2-hifigan-v1", True, "498ed9dbbb17f76641da5d4ed7ecfefa1c5735c88e2416382eb68637ed9df95d"),
])
def test_seeded_trees_are_drawn_as_before(name, tiny, digest):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    sizes = dict(config["sizes"], **(TINY if tiny else {}))
    trees = seeded_trees(sizes, 2**31 + 3, CPU, config["weights"], cells.load_models(config))
    assert _digest(trees) == digest


TOY = '''"""A toy vocoder: conv_pre k=7 to a few channels, each frame held for a
hop, conv_post k=7, tanh."""

import torch

from perfbench.harness.weights import Leaf
from perfbench.reference.models import layers


def leaves(sizes, gains):
    C = sizes["toy.channels"]
    return layers.conv_leaves(("params", "conv_pre"), 7, sizes["dsp.mel_dim"], C) + [
        Leaf(("params", "conv_post", "kernel"), (7, C, 1), gains["toy_gain"]), Leaf(("params", "conv_post", "bias"), (1,), 0.0)]


def wave(tree, sizes, mel, dtype):
    g = tree["params"]
    x = layers.conv(mel.transpose(1, 2), g["conv_pre"]).repeat_interleave(sizes["dsp.hop_length"], -1)
    return torch.tanh(layers.conv(x, g["conv_post"]))[:, 0]


def generator_flops(sizes, n_frames, batch=1, conv_pre=True):
    C, L = sizes["toy.channels"], n_frames * sizes["dsp.hop_length"]
    pre = layers.conv1d_flops(n_frames, sizes["dsp.mel_dim"], C, 7, batch) if conv_pre else 0
    return pre + layers.conv1d_flops(L, C, 1, 7, batch)


def stage_counts(sizes, frames, element_bytes=2):
    return float(generator_flops(sizes, frames, conv_pre=False)), float(element_bytes * frames * 1000)


def weight_bytes(sizes, element_bytes=2):
    return float(element_bytes * (7 * sizes["toy.channels"] + 1))
'''


def _toy_root(tmp_path: Path, vocoder: str = "toyvoc") -> Path:
    """A checkout's benchmark files (model modules, traffic, the limits of
    a cell) with the toy vocoder's module and a configuration naming it
    added."""
    bench = tmp_path / "perfbench"
    shutil.copytree(BENCH / "reference" / "models", bench / "reference" / "models",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "reference" / "models" / "toyvoc.py").write_text(TOY)
    shutil.copytree(BENCH / "traffic", bench / "traffic")
    (bench / "limits").mkdir()
    shutil.copy(BENCH / "limits" / "infore.bulk64.json", bench / "limits" / "toy.bulk64.json")
    config = json.loads((BENCH / "configs" / "viettts-infore.json").read_text())
    config["sizes"].update(TINY, **{"toy.channels": 4})
    config["weights"]["toy_gain"] = 0.3
    config["models"] = {"vocoder": vocoder}
    (bench / "configs").mkdir()
    (bench / "configs" / "toy.json").write_text(json.dumps(config))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "toy", "source": "a test", "file": "perfbench/configs/toy.json", "reduced": [],
                        "why": "a toy vocoder"}]
    spec["workloads"] = [{"name": "toy.bulk64", "config": "toy", "traffic": "bulk64", "chips": 1, "why": "a test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_a_new_vocoder_is_new_files_only(tmp_path):
    from perfbench.harness import drivers
    from perfbench.harness.trace import Trace
    from perfbench.reference import frontend
    from perfbench.reference.model import Reference

    cell = cells.load("toy.bulk64", root=_toy_root(tmp_path))
    toy, sizes = cell.models.vocoder, cell.config["sizes"]
    assert Path(toy.__file__) == tmp_path / "perfbench" / "reference" / "models" / "toyvoc.py"
    assert Path(cell.models.acoustic.__file__).name == "viettts_acoustic.py"

    # the trees: the toy's leaves under the vocoder's checkpoint, after the same duration and acoustic draws
    trees = seeded_trees(sizes, 2**31 + 5, CPU, cell.config["weights"], cell.models)
    default = copy.deepcopy(cell.config)
    del default["models"]
    base = seeded_trees(sizes, 2**31 + 5, CPU, cell.config["weights"], cells.load_models(default))
    assert _digest({k: trees[k] for k in ("duration", "acoustic")}) == _digest(
        {k: base[k] for k in ("duration", "acoustic")})
    assert {k: v.shape for k, v in trees["hifigan"]["params"]["conv_post"].items()} == {"kernel": (7, 4, 1),
                                                                                        "bias": (1,)}
    assert abs(float(trees["hifigan"]["params"]["conv_post"]["kernel"].std()) - 0.3) < 0.15

    # the reference's waveform is the toy's
    ref = Reference(trees, sizes, CPU, cell.models)
    mel = torch.randn(2, 5, 80, generator=torch.Generator().manual_seed(1))
    got = ref.wave(mel)
    assert got.shape == (2, 5 * 256)
    assert torch.equal(got, toy.wave(ref.trees["vocoder"], sizes, mel, "bfloat16"))

    # the vocoder roofline and the whole step's share read the toy's counts
    record = drivers.Record()
    texts = ["xin chào các bạn"]
    for t0 in (0.0, 1.0):  # one untraced call, one traced: the same time a sample, no profiler cost
        record.dispatches.append(drivers.Dispatch("batch", texts, [], [256 * 100], {}, t0, t0 + 0.5))
    trace = Trace(window_s=0.5, busy_s=0.4, ops=[("Bf16Mma_stage", 0, 10 ** 6)], host=[], span=(1.0, 1.5))
    ctx = core.Context(trace, record, sizes, H100_SXM, 256, cell.models)
    flop, bytes_ = toy.stage_counts(sizes, 100)
    expected = 100.0 * bound_seconds(flop, bytes_ + toy.weight_bytes(sizes), H100_SXM.bf16, H100_SXM) / 1e-3
    assert core._reader("vocoder_roofline_pct.bulk")(ctx) == pytest.approx(expected, rel=1e-12)
    n = len(frontend.tokens(texts[0]))
    m = cell.models
    step = m.duration.flops(sizes, n) + m.acoustic.decode_flops(sizes, n, 100) + toy.generator_flops(sizes, 100)
    assert core._reader("mfu_pct.bulk")(ctx) == pytest.approx(100.0 * step / 0.5 / H100_SXM.bf16, rel=1e-12)


def test_a_configuration_naming_no_module_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="no vocoder model module bigvgan.py"):
        cells.load("toy.bulk64", root=_toy_root(tmp_path, vocoder="bigvgan"))
    with pytest.raises(KeyError, match="no role"):
        cells.load_models({"models": {"decoder": "hifigan"}})


def test_program_config_sets_hifigan_v3s_dilations():
    from perfbench.harness.program import program_config

    v3 = {"hifigan.resblock": "2", "hifigan.upsample_rates": [8, 8, 4], "hifigan.upsample_kernel_sizes": [16, 16, 8],
          "hifigan.upsample_initial_channel": 256, "hifigan.resblock_kernel_sizes": [3, 5, 7],
          "hifigan.resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]}
    cfg = program_config(v3)
    assert cfg.hifigan.resblock_dilation_sizes == ((1, 2), (2, 6), (3, 12))
    assert cfg.hifigan.upsample_rates == (8, 8, 4) and cfg.hifigan.resblock == "2"

