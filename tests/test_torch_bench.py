"""The port's benchmark programs (``viettts_tpu_torch/bench``) against the
JAX package's measuring programs, on the CPU.

The JAX programs (``bench.py``, ``scripts/bench_batch.py``,
``scripts/bench_train.py``, ``scripts/tune_vocoder_batch.py``,
``scripts/bench_b1_vocoder.py``, ``scripts/bench_stream.py``) are read with ``ast``, never imported or
run: each port module's shape constants must be theirs, its result must
carry the keys they print or write, and its rates must be their
arithmetic on the same timings.  The port's programs run here at tiny
widths and small shapes, one warm-up and one timed run, on the plain
twins: the launch counters must show twins and no kernel, and without a
card ``main`` must raise rather than fall back.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from viettts_tpu_torch.bench import b1_vocoder, batch, common, e2e, stream, train, vocoder_batch

from test_torch_pipeline import port_config

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "bench.py"
BENCH_BATCH = REPO / "scripts" / "bench_batch.py"
BENCH_TRAIN = REPO / "scripts" / "bench_train.py"
TUNE_VOCODER = REPO / "scripts" / "tune_vocoder_batch.py"
BENCH_B1 = REPO / "scripts" / "bench_b1_vocoder.py"
BENCH_STREAM = REPO / "scripts" / "bench_stream.py"
MODULES = {"e2e": e2e, "batch": batch, "train": train, "vocoder_batch": vocoder_batch, "b1_vocoder": b1_vocoder,
           "stream": stream}


def _tree(path):
    return ast.parse(path.read_text(encoding="utf-8"), str(path))


def _eval(node, namespace=None):
    return eval(compile(ast.Expression(node), "<jax program>", "eval"), {"__builtins__": {}}, namespace or {})


def _constants(path):
    """Module-level constants (``NAME = expr`` and ``A, B = x, y``)."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name):
                try:
                    out[target.id] = _eval(node.value)
                except Exception:
                    pass
            elif isinstance(target, ast.Tuple) and isinstance(node.value, ast.Tuple):
                for name, value in zip(target.elts, node.value.elts):
                    out[name.id] = _eval(value)
    return out


def _function(path, name):
    return next(n for n in ast.walk(_tree(path)) if isinstance(n, ast.FunctionDef) and n.name == name)


def _defaults(path, name):
    """A function's keyword defaults, by argument name."""
    fn = _function(path, name)
    args = fn.args.args[len(fn.args.args) - len(fn.args.defaults):]
    return {a.arg: _eval(d) for a, d in zip(args, fn.args.defaults)}


def _assigned(path, func, name):
    """The expression a function assigns to ``name`` (its last assignment)."""
    found = [n.value for n in ast.walk(_function(path, func))
             if isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == name for t in n.targets)]
    return found[-1]


def _keys(node):
    """A dict display's constant keys; nested dict displays as dicts."""
    return {k.value: (_keys(v) if isinstance(v, ast.Dict) else None) for k, v in zip(node.keys, node.values)}


def _printed_dict(path, func):
    """The dict display passed to ``json.dumps`` inside ``print``."""
    for n in ast.walk(_function(path, func)):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps":
            if isinstance(n.args[0], ast.Dict):
                return n.args[0]
    raise AssertionError(f"no json.dumps of a dict display in {path}:{func}")


def _assert_has_keys(result, keys, where):
    for key, sub in keys.items():
        assert key in result, f"{where}: missing {key!r}"
        if sub is not None and result[key] is not None:
            _assert_has_keys(result[key], sub, f"{where}.{key}")


def _tiny_cfg():
    """``tests/test_torch_pipeline.py``'s tiny widths, with narrow
    discriminators and a short GAN segment for the training program."""
    from test_torch_pipeline import _cfg

    cfg = port_config(_cfg())
    return cfg.replace(hifigan=dataclasses.replace(
        cfg.hifigan, inference_dtype="bfloat16", mpd_base_channels=4, msd_scales=1, msd_base_channels=16,
        segment_size=512))


# --- the JAX programs' shapes -------------------------------------------------


def test_e2e_shapes_are_bench_py_s():
    jax = _constants(BENCH)
    for name in ("TARGET_RTF", "N_FRAMES", "N_TOKENS", "BATCH", "WARMUP", "ITERS"):
        assert getattr(e2e, name) == jax[name], name
    assert (e2e.N_FRAMES, e2e.N_TOKENS, e2e.BATCH, e2e.WARMUP, e2e.ITERS) == (1024, 256, 1, 2, 5)


def test_batch_shapes_are_bench_batch_s():
    jax = _constants(BENCH_BATCH)
    for name in ("BATCH", "N_TOKENS", "N_FRAMES", "K"):
        assert getattr(batch, name) == jax[name], name
    assert (batch.BATCH, batch.N_TOKENS, batch.N_FRAMES) == (64, 256, 768)


def test_train_shapes_are_bench_train_s():
    jax = _constants(BENCH_TRAIN)
    for name in ("BATCH", "SEQ_LEN", "WAVE_LEN", "STEPS_PER_UPDATE", "UPDATES"):
        assert getattr(train, name) == jax[name], name
    gan = _defaults(BENCH_TRAIN, "bench_gan")
    assert (train.GAN_BATCH, train.GAN_STEPS) == (gan["batch"], gan["steps"]) == (16, 6)
    assert train.WAVE_LEN == 196_608


def test_vocoder_batch_shapes_are_tune_vocoder_batch_s():
    jax = _constants(TUNE_VOCODER)
    assert (vocoder_batch.N_FRAMES, vocoder_batch.K) == (jax["N_FRAMES"], jax["K"]) == (768, 8)
    loops = [n.iter for n in ast.walk(_function(TUNE_VOCODER, "main"))
             if isinstance(n, ast.For) and isinstance(n.target, ast.Name) and n.target.id == "batch"]
    assert vocoder_batch.BATCHES == _eval(loops[0]) == (1, 8, 16, 32, 64)


def test_b1_vocoder_shapes_are_bench_b1_vocoder_s():
    assert b1_vocoder.K == _constants(BENCH_B1)["K"] == 16
    assert b1_vocoder.N_FRAMES == _defaults(BENCH_B1, "main")["n_frames"] == 1024
    routes = _assigned(BENCH_B1, "main", "routes")
    assert [k.value for k in routes.keys] == ["float32", "bfloat16", "int8-dynamic", "int8-static"]


def test_stream_shapes_are_bench_stream_s():
    """The text (its sentence and repeats), the pinned 80 ms a token, the
    lead chunk of 64 tokens against 0, and the best of 3 runs, read from
    ``bench_stream.py``'s ``main``."""
    main = _function(BENCH_STREAM, "main")
    assert stream.SENTENCE == _eval(_assigned(BENCH_STREAM, "main", "sentence"))
    text = _assigned(BENCH_STREAM, "main", "text")
    assert isinstance(text, ast.BinOp) and isinstance(text.op, ast.Mult) and stream.REPEATS == _eval(text.right) == 12
    fulls = [n for n in ast.walk(main) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "full"]
    assert [_eval(f.args[1]) for f in fulls] == [stream.DURATION_S] == [0.08]
    leads = {_eval(n.args[0]) for n in ast.walk(main) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
             and n.func.id == "streamed"}
    assert leads == {stream.LEAD_TOKENS, 0} and stream.LEAD_TOKENS == 64
    ranges = {_eval(n.args[0]) for n in ast.walk(main) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
              and n.func.id == "range"}
    assert ranges == {stream.ITERS} == {3}
    assert json.loads((REPO / "benchmarks" / "stream_results.json").read_text())["text_tokens"] == 530


@pytest.mark.parametrize("name", MODULES)
def test_run_defaults_are_the_module_constants(name):
    """``run`` measures the JAX program's shapes unless told otherwise."""
    import inspect

    module = MODULES[name]
    params = inspect.signature(module.run).parameters
    consts = {"e2e": dict(iters="ITERS", warmup="WARMUP", n_tokens="N_TOKENS", n_frames="N_FRAMES", batch="BATCH"),
              "batch": dict(iters="K", batch="BATCH", n_tokens="N_TOKENS", n_frames="N_FRAMES"),
              "train": dict(iters="UPDATES", batch="BATCH", seq_len="SEQ_LEN", wave_len="WAVE_LEN",
                            steps_per_update="STEPS_PER_UPDATE", gan_batch="GAN_BATCH", gan_steps="GAN_STEPS"),
              "vocoder_batch": dict(iters="K", batches="BATCHES", n_frames="N_FRAMES"),
              "b1_vocoder": dict(iters="K", n_frames="N_FRAMES"),
              "stream": dict(iters="ITERS", warmup="WARMUP", repeats="REPEATS", lead_tokens="LEAD_TOKENS")}[name]
    for arg, const in consts.items():
        assert params[arg].default == getattr(module, const), (arg, const)
    assert params["device"].default == "cuda"


def test_parameter_counts_are_the_models_and_jax_s():
    """``utils.flops.parameter_counts`` (what each program holds its
    seeded models to) counts the port's modules at ``Config()`` widths and
    at tiny ones, and the JAX package's parameters at tiny widths."""
    import jax
    import jax.numpy as jnp

    from test_torch_pipeline import _cfg

    from viettts_tpu.models import AcousticModel as JaxAcoustic, DurationModel as JaxDuration, Generator as JaxGen
    from viettts_tpu.types import AcousticBatch, DurationBatch
    from viettts_tpu_torch.config import Config
    from viettts_tpu_torch.models.acoustic import AcousticModel
    from viettts_tpu_torch.models.duration import DurationModel
    from viettts_tpu_torch.models.hifigan import Generator
    from viettts_tpu_torch.utils.flops import parameter_counts

    for cfg in (Config(), _tiny_cfg()):
        with torch.device("meta"):
            models = {"duration": DurationModel(cfg.duration), "acoustic": AcousticModel(cfg.acoustic),
                      "generator": Generator(cfg.hifigan)}
        assert common.check_widths(cfg, models) == parameter_counts(cfg)

    jcfg = _cfg()
    toks, lengths = jnp.zeros((1, 8), jnp.int32), jnp.asarray([8], jnp.int32)
    keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "prenet", "zoneout"))}

    def n_params(model, *args, **kwargs):
        tree = jax.eval_shape(lambda: model.init(*args, **kwargs))["params"]
        return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))

    want = {
        "duration": n_params(JaxDuration(jcfg.duration), keys, DurationBatch(toks, lengths, None), train=False),
        "acoustic": n_params(JaxAcoustic(jcfg.acoustic), keys, AcousticBatch(
            toks, lengths, jnp.ones((1, 8)), None, None, jnp.zeros((1, 16, 80))), train=True),
        "generator": n_params(JaxGen(jcfg.hifigan), jax.random.PRNGKey(0), jnp.zeros((1, 16, 80))),
    }
    assert parameter_counts(port_config(jcfg)) == want


# --- results: the JAX programs' keys, counters on the CPU --------------------


@pytest.fixture(scope="module")
def results():
    cfg = _tiny_cfg()
    small = dict(iters=1, warmup=1)
    return {
        "e2e": e2e.run(cfg, "cpu", n_tokens=32, n_frames=128, **small),
        "batch": batch.run(cfg, "cpu", batch=4, n_tokens=32, n_frames=128, **small),
        "batch_int8": batch.run(cfg, "cpu", vocoder_dtype="int8", int8_static=True, batch=2, n_tokens=16,
                                n_frames=64, **small),
        "train": train.run(cfg, "cpu", batch=2, seq_len=8, wave_len=2048, steps_per_update=2, gan_batch=2,
                           gan_steps=1, **small),
        "vocoder_batch": vocoder_batch.run(cfg, "cpu", batches=(1, 4), n_frames=64, **small),
        "b1_vocoder": b1_vocoder.run(cfg, "cpu", n_frames=64, **small),
        "stream": stream.run(cfg, "cpu", iters=1, warmup=0),
    }


def test_e2e_keys_are_bench_py_s(results):
    got = results["e2e"]
    _assert_has_keys(got, _keys(_printed_dict(BENCH, "main")), "printed")
    _assert_has_keys(got, _keys(_assigned(BENCH, "main", "details")), "results.json")
    for key in ("device", "route", "runs_s", "stage_ms", "launches"):
        assert key in got
    assert got["metric"] == "end_to_end_rtf" and got["backend"] == "cpu" and len(got["runs_s"]) == 1
    assert set(got["stage_ms"]) == {"duration", "decode", "vocoder"}
    assert json.loads(json.dumps(got)) == got


def test_batch_keys_are_bench_batch_s(results):
    want = _keys(_assigned(BENCH_BATCH, "main", "results"))
    for name in ("batch", "batch_int8"):
        got = results[name]
        _assert_has_keys(got, want, name)
        for key in ("device", "runs_full_ms", "runs_vocoder_ms", "stage_ms", "launches"):
            assert key in got
        _assert_has_keys(got["vocoder_quality"], _keys(_assigned(BENCH_BATCH, "main", "quality")), name)
    assert results["batch"]["int8_scales"] is None and results["batch_int8"]["int8_scales"] == "static"


def test_train_keys_are_bench_train_s(results):
    got = results["train"]
    _assert_has_keys(got, _keys(_assigned(BENCH_TRAIN, "main", "results")), "train_results.json")
    assert "vocoder_gan" in got
    gan_keys = set(_keys(_assigned(BENCH_TRAIN, "bench_gan", "out")))
    prefixes = {n.values[0].value for n in ast.walk(_function(BENCH_TRAIN, "bench_gan")) if isinstance(n, ast.JoinedStr)}
    assert prefixes == {"steps_per_sec_", "mel_l1_"}
    gan_keys |= {p + k for p in prefixes for k in ("f32", "bf16")}
    _assert_has_keys(got["vocoder_gan"], dict.fromkeys(gan_keys), "vocoder_gan")
    assert np.isfinite(got["final_loss"]) and all(np.isfinite(got["vocoder_gan"][f"mel_l1_{k}"]) for k in ("f32", "bf16"))
    assert len(got["runs_s"]) == 1


def test_vocoder_programs_report_every_route(results):
    rows = results["vocoder_batch"]["rows"]
    assert [(r["batch"], r["route"]) for r in rows] == [(1, "float32"), (1, "bfloat16"), (4, "float32"), (4, "bfloat16")]
    assert set(results["vocoder_batch"]["quality"]) == {"max_abs_dwave", "mean_abs_dwave", "wave_rms"}
    assert list(results["b1_vocoder"]["routes"]) == ["float32", "bfloat16", "int8-dynamic", "int8-static"]
    for r in rows + list(results["b1_vocoder"]["routes"].values()):
        assert r["ms"] > 0 and len(r["runs_ms"]) == 1


@pytest.mark.parametrize("name,plain", [
    ("e2e", ("ar_decode", "fused_mrf", "bidirectional_lstm")), ("batch", ("ar_decode", "fused_mrf", "bidirectional_lstm")),
    ("batch_int8", ("ar_decode", "fused_mrf_int8", "bidirectional_lstm")), ("train", ("bidirectional_lstm",)),
    ("vocoder_batch", ("fused_mrf",)), ("b1_vocoder", ("fused_mrf_int8",)),
    ("stream", ("ar_decode", "fused_mrf", "bidirectional_lstm")),
])
def test_counters_show_twins_and_no_kernel_on_the_cpu(results, name, plain):
    counts = results[name]["launches"]
    assert all(c["launches"] == 0 for c in counts.values())
    assert all(counts[k]["plain_calls"] > 0 for k in plain)
    if set(plain) <= set(common.TRAINING_TWINS):  # the trainers: no twin but the bi-LSTM loop
        assert all(c["plain_calls"] == 0 for n, c in counts.items() if n not in plain)


def test_read_counters_refuses_a_twin_on_the_card():
    common.zero_counters()
    from viettts_tpu_torch.ops.mrf import fused_mrf

    fused_mrf.plain_calls = 1
    with pytest.raises(AssertionError, match="launch counters"):
        common.read_counters(torch.device("cuda"), [])
    common.zero_counters()


def test_read_counters_refuses_the_lstm_loop_only_where_its_kernel_is_expected():
    """The bi-LSTM loop is also the card's training route: a run that does
    not expect the kernel may call it; one that expects it may not."""
    from viettts_tpu_torch.ops.rnn import bidirectional_lstm

    common.zero_counters()
    bidirectional_lstm.plain_calls = 1
    assert common.read_counters(torch.device("cuda"), [])["bidirectional_lstm"]["plain_calls"] == 1
    bidirectional_lstm.launches = 1
    with pytest.raises(AssertionError, match="launch counters"):
        common.read_counters(torch.device("cuda"), ["bidirectional_lstm"])
    common.zero_counters()


def test_stream_keys_are_bench_stream_s(results):
    """``bench_stream.py``'s keys, its 530-token text on the port's front
    end, and the port's: the device, every run unrounded, the launches."""
    got = results["stream"]
    _assert_has_keys(got, _keys(_assigned(BENCH_STREAM, "main", "result")), "stream_results.json")
    for key in ("device", "route", "runs_s", "launches"):
        assert key in got
    assert got["text_tokens"] == 530 and got["backend"].startswith("cpu") and got["samples_match"]
    assert set(got["runs_s"]) == {"one_shot", "stream_first_chunk", "stream_total", "stream_first_chunk_full_lead"}
    assert json.loads(json.dumps(got)) == got


# --- the JAX programs' arithmetic ----------------------------------------------


def test_rates_are_the_jax_programs_arithmetic():
    """The audio seconds, RTF and per-second rates of each program, from
    the JAX source's own expressions evaluated on the same timings."""
    from viettts_tpu_torch.config import Config

    cfg = Config()
    elapsed, t_voc, t_ac = 0.1234, 0.0321, 0.0456
    ns = dict(cfg=cfg, elapsed=elapsed, t_voc=t_voc, t_ac=t_ac, **_constants(BENCH))
    ns["audio_seconds"] = _eval(_assigned(BENCH, "main", "audio_seconds"), ns)
    ns["rtf"] = _eval(_assigned(BENCH, "main", "rtf"), ns)
    details = _assigned(BENCH, "main", "details")
    printed = _printed_dict(BENCH, "main")
    want = {k.value: _eval(v, ns) for k, v in zip(details.keys + printed.keys, details.values + printed.values)
            if k.value in ("end_to_end_rtf", "vocoder_samples_per_sec", "acoustic_mel_frames_per_sec", "value",
                           "vs_baseline")}
    got = e2e.rates(cfg, e2e.BATCH, e2e.N_FRAMES, elapsed, t_voc, t_ac)
    assert got["audio_seconds"] == pytest.approx(ns["audio_seconds"], rel=1e-12)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k

    t_full = 0.789
    ns = dict(cfg=cfg, t_full=t_full, t_voc=t_voc, **_constants(BENCH_BATCH))
    ns["audio_secs"] = _eval(_assigned(BENCH_BATCH, "main", "audio_secs"), ns)
    results = _assigned(BENCH_BATCH, "main", "results")
    got = batch.rates(cfg, batch.BATCH, batch.N_FRAMES, t_full, t_voc)
    for k, v in zip(results.keys, results.values):
        if k.value in got:
            assert got[k.value] == pytest.approx(_eval(v, ns), rel=1e-12), k.value

    full_s, first_s, first_full, stream_total_s = 0.1711, 0.0523, 0.1379, 0.3397
    ns = dict(full_s=full_s, first_s=first_s, first_full=first_full, stream_total_s=stream_total_s, round=round)
    result = _assigned(BENCH_STREAM, "main", "result")
    got = stream.rates(full_s, first_s, first_full, stream_total_s)
    assert set(got) < {k.value for k in result.keys}
    for k, v in zip(result.keys, result.values):
        if k.value in got:
            assert got[k.value] == _eval(v, ns), k.value

    dt = 12.5
    ns = dict(cfg=cfg, dt=dt, **_constants(BENCH_TRAIN))
    ns["steps"] = _eval(_assigned(BENCH_TRAIN, "main", "steps"), ns)
    results = _assigned(BENCH_TRAIN, "main", "results")
    got = train.acoustic_rates(cfg, ns["steps"], train.BATCH, train.WAVE_LEN, dt)
    assert set(got) <= {k.value for k in results.keys}
    for k, v in zip(results.keys, results.values):
        if k.value in got:
            assert got[k.value] == pytest.approx(_eval(v, ns), rel=1e-12), k.value


# --- main: the card or nothing; output ---------------------------------------


@pytest.mark.parametrize("name", MODULES)
def test_main_without_a_card_raises(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "out.json"
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MODULES[name].main(argv + ["--out", str(out)])
    assert not out.exists()


def test_main_prints_the_card_then_one_json_line(tmp_path, capsys, monkeypatch):
    """``main --device cpu`` (``Config()`` swapped for the tiny widths):
    the device's line first, the result as the last line and in ``--out``."""
    monkeypatch.setattr(e2e, "Config", _tiny_cfg)
    out = tmp_path / "e2e.json"
    assert e2e.main(["--device", "cpu", "--iters", "1", "--warmup", "0", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("card: cpu")
    last = json.loads(lines[-1])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(last)
    assert json.loads(out.read_text()) == last


def test_results_are_never_written_under_benchmarks(tmp_path):
    with pytest.raises(ValueError, match="benchmarks/"):
        common.write_result({}, REPO / "benchmarks" / "results.json", "e2e")
    assert common.write_result({"a": 1}, tmp_path / "x.json", "e2e").read_text() == '{\n  "a": 1\n}'
    assert common.OUT_DIR == Path("runs/bench")
