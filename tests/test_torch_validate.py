"""The port's validation tools (``viettts_tpu_torch/tools/``: ``synth_corpus``,
``validate_gan``, ``validate_int8``, ``diagnose_int8``,
``validate_e2e_training``) against the JAX package's scripts and routes,
on the CPU at tiny widths.

Bars:

* both synthetic corpora byte for byte equal to the scripts' (the same
  numpy streams, WAV writers and TextGrid text);
* ``validate_int8``'s routes on a seeded tiny generator against the JAX
  package's (``generator_apply_fused`` in interpret mode, ``Generator.apply``
  for float32): float32 1e-5, bf16 0.02 (the bar of
  ``tests/test_torch_models.py``), static and dynamic int8 rel-RMS 5e-3 and
  max abs 0.02 of max(|ref|, 1) (the int8 parity bars of PERF.md §2); the
  per-clip rel-RMS metrics then within 5e-3 + 1e-5 of the metric on JAX's
  waves (|rel(a) - rel(b)| <= rel-RMS(a, b) by the triangle inequality),
  the calibration and clip fraction 1e-5 relative;
* ``diagnose_int8``'s walk against ``scripts/diagnose_int8.py::
  generator_walk`` in every mode, given the same calibration: within 1e-5
  unquantized and with int8 weights alone (their codes come from the same
  float32 weights); with quantized activations at the int8 parity bars,
  since a conv input that the two sides' float32 sums round apart by an
  ulp can land on the other side of a rounding boundary and flip its code;
  the recorded statistics within 1e-5 relative (the 99.9th percentile
  1e-4: JAX interpolates it at a float32 index);
* ``validate_gan``'s held-out MCD probe within 1e-4 dB of JAX's on the same
  weight-normalized generator;
* ``validate_e2e_training``'s criteria functions against the script's.
"""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viettts_tpu.config import DspConfig as JaxDspConfig, HifiGanConfig as JaxHifiGanConfig
from viettts_tpu.models import hifigan as jax_hifigan
from viettts_tpu.ops.mel import LogMelSpectrogram as JaxMel
from viettts_tpu.utils.metrics import mel_cepstral_distortion as jax_mcd
from viettts_tpu_torch.checkpoint import NATIVE_FORMAT
from viettts_tpu_torch.config import Config, DspConfig
from viettts_tpu_torch.models import hifigan
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.tools import diagnose_int8, synth_corpus, validate_e2e_training, validate_gan, validate_int8
from tests.test_torch_models import _generator, _hifigan_cfg
from tests.test_torch_pipeline import port_config

REPO = Path(__file__).resolve().parents[1]
FRAMES = 16  # one time tile of JAX's dynamic int8 scale


def _script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / "scripts"))


def _tree_bytes(d: Path):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ---------------------------------------------------------------------------
# The corpora.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(6, 0), (5, 3)])
def test_aligned_corpus_equals_the_scripts(tmp_path, n, seed):
    want, got = tmp_path / "jax", tmp_path / "port"
    want.mkdir()
    _script("validate_e2e_training").build_corpus(want, n_utts=n, seed=seed)
    synth_corpus.build_corpus(got, n_utts=n, seed=seed)
    ours, theirs = _tree_bytes(got), _tree_bytes(want)
    assert sorted(ours) == sorted(theirs) and len(ours) == 2 * n + 1
    for name, data in theirs.items():
        assert ours[name] == data, name


def test_gan_corpus_and_heldout_clip_equal_the_scripts(tmp_path):
    script = _script("validate_gan")
    want, got = tmp_path / "jax", tmp_path / "port"
    want.mkdir()
    script.synth_corpus(want, n=5)
    synth_corpus.synth_corpus(got, n=5)
    assert _tree_bytes(got) == _tree_bytes(want) and len(_tree_bytes(got)) == 5
    np.testing.assert_array_equal(synth_corpus.heldout_clip(), script.heldout_clip())
    # a grown corpus extends the smaller one: the first clips are kept
    synth_corpus.synth_corpus(got, n=7)
    script.synth_corpus(want, n=7)
    assert _tree_bytes(got) == _tree_bytes(want)


# ---------------------------------------------------------------------------
# validate_int8 against the JAX routes.
# ---------------------------------------------------------------------------


def _rel_rms(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def _int8_close(got, want):
    assert got.shape == want.shape
    assert _rel_rms(got, want) <= 5e-3
    assert np.abs(got - want).max() <= 0.02 * max(float(np.abs(want).max()), 1.0)


@pytest.fixture(scope="module")
def tiny_generator():
    """A seeded ResBlock1 generator at 32 channels on both sides, a mel
    [2, 16, 80] and two calibration mels."""
    cfg = _hifigan_cfg("1")
    gen, variables, port, mel = _generator(cfg, seed=8, T=FRAMES)
    rng = np.random.RandomState(9)
    calib = [rng.randn(1, FRAMES, 80).astype(np.float32) for _ in range(2)]
    return cfg, gen, variables, port, mel, calib


def test_int8_clip_metrics_match_the_jax_routes(tiny_generator):
    cfg, gen, variables, port, mel, calib = tiny_generator
    params = variables["params"]
    scales = validate_int8.calibrate(port, [torch.from_numpy(m) for m in calib], 1.25)
    want_scales = None
    for m in calib:
        s = jax_hifigan.generator_calibrate_int8(cfg, params, jnp.asarray(m))
        want_scales = s if want_scales is None else jax.tree.map(jnp.maximum, want_scales, s)
    want_scales = jax.tree.map(lambda s: s * 1.25, want_scales)
    for i in want_scales:
        np.testing.assert_allclose(scales[i].numpy(), np.asarray(want_scales[i]), rtol=1e-5)
    jscales = {i: jnp.asarray(v.numpy()) for i, v in scales.items()}
    mel_fn = LogMelSpectrogram(DspConfig())

    def jax_waves(m):
        fused = dict(compute_dtype=jnp.bfloat16, interpret=True)
        return {
            "f32": gen.apply(variables, m),
            "bf16": jax_hifigan.generator_apply_fused(cfg, params, m, **fused),
            "int8": jax_hifigan.generator_apply_fused(cfg, params, m, quantize_int8=True, act_scales=jscales, **fused),
            "int8_dynamic": jax_hifigan.generator_apply_fused(cfg, params, m, quantize_int8=True, **fused),
        }

    m = mel[:1]  # one clip: JAX's interpret-mode routes take ~40 s a clip
    got = validate_int8.route_waves(port, torch.from_numpy(m), scales)
    want = {k: np.asarray(v, np.float64) for k, v in jax_waves(jnp.asarray(m)).items()}
    np.testing.assert_allclose(got["f32"], want["f32"], atol=1e-5)
    np.testing.assert_allclose(got["bf16"], want["bf16"], atol=0.02)
    _int8_close(got["int8"], want["int8"])
    _int8_close(got["int8_dynamic"], want["int8_dynamic"])
    clip = float(max(v.max() for v in hifigan.generator_int8_clip_stats(port, torch.from_numpy(m), scales).values()))
    want_clip = float(max(np.max(v) for v in jax_hifigan.generator_int8_clip_stats(
        cfg, params, jnp.asarray(m), jscales).values()))
    assert clip == pytest.approx(want_clip, rel=1e-5, abs=1e-7)
    ours = validate_int8.clip_metrics("clip", got, mel_fn, clip)
    theirs = validate_int8.clip_metrics("clip", want, mel_fn, want_clip)
    assert sorted(ours) == sorted(theirs)
    for k in ("rel_rms_vs_f32", "int8_dynamic_rel_rms_vs_f32", "bf16_rel_rms_vs_f32"):
        assert abs(ours[k] - theirs[k]) <= 5e-3 + 1e-5, k
    assert 0 < ours["rel_rms_vs_f32"] < 0.05 and 0 < ours["int8_dynamic_rel_rms_vs_f32"] < 0.05


@pytest.mark.parametrize("n_eval", [1, 3])
def test_validate_int8_evaluates_n_eval_clips(tiny_generator, tmp_path, n_eval):
    """``--n-eval 1`` is the held-out clip alone (the script's
    ``files[-0:]`` takes the whole corpus); more adds the last corpus
    clips.  The result has the script's keys."""
    cfg, gen, variables, port, mel, calib = tiny_generator
    ckpt = tmp_path / "hifigan_latest_ckpt.pickle"
    with open(ckpt, "wb") as f:
        pickle.dump({"format": NATIVE_FORMAT, "step": 0, "variables": variables}, f)
    corpus = tmp_path / "corpus"
    synth_corpus.synth_corpus(corpus, n=validate_int8.CORPUS_CLIPS)
    result = validate_int8.run(ckpt, corpus, n_eval, out=tmp_path / "out", device="cpu",
                               cfg=Config(hifigan=port_config(cfg)))
    assert [c["clip"] for c in result["per_clip"]] == ["heldout_seed12345"] + [
        f"syn{i:03d}" for i in range(validate_int8.CORPUS_CLIPS - n_eval + 1, validate_int8.CORPUS_CLIPS)]
    assert result["calibration"] == {"n_clips": 4, "margin": 1.25, "disjoint_from_eval": True}
    written = json.loads((tmp_path / "out" / "int8_quality.json").read_text())
    assert sorted(written) == sorted(result) == sorted([
        "ckpt", "weights", "backend", "calibration", "rel_rms_vs_f32_mean", "rel_rms_vs_f32_max",
        "mcd_db_int8_vs_f32_mean", "mcd_db_int8_vs_f32_max", "bf16_rel_rms_vs_f32_mean", "bf16_rel_rms_vs_f32_max",
        "mcd_db_bf16_vs_f32_mean", "mcd_db_bf16_vs_f32_max", "int8_dynamic_rel_rms_vs_f32_mean",
        "mcd_db_int8_dynamic_vs_f32_mean", "max_clip_fraction", "per_clip"])
    assert all(np.isfinite(c["rel_rms_vs_f32"]) and c["f32_rms"] > 0 for c in result["per_clip"])
    with pytest.raises(ValueError, match="n-eval"):
        validate_int8.run(ckpt, corpus, 0, out=None, device="cpu", cfg=Config(hifigan=port_config(cfg)))


# ---------------------------------------------------------------------------
# diagnose_int8's walk against the script's.
# ---------------------------------------------------------------------------


def _jax_walk_with_the_generators_post_slope(script, cfg, monkeypatch):
    """``script.generator_walk`` with its last leaky_relu at the generator's
    slope (0.01, ``viettts_tpu/models/hifigan.py:187``), where the script
    has 0.1: every other call keeps its slope."""
    convs = 2 if cfg.resblock == "1" else 1
    n_calls = len(cfg.upsample_rates) * (1 + sum(len(d) * convs for d in cfg.resblock_dilation_sizes)) + 1
    lrelu = jax.nn.leaky_relu

    def walk(*args, **kwargs):
        count = [0]

        def counted(x, negative_slope=0.01):
            count[0] += 1
            return lrelu(x, 0.01 if count[0] == n_calls else negative_slope)

        monkeypatch.setattr(jax.nn, "leaky_relu", counted)
        try:
            return script.generator_walk(*args, **kwargs)
        finally:
            monkeypatch.setattr(jax.nn, "leaky_relu", lrelu)
            assert count[0] == n_calls

    return walk


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_diagnosis_walk_matches_the_script(resblock, monkeypatch):
    script = _script("diagnose_int8")
    cfg = _hifigan_cfg(resblock)
    gen, variables, port, mel = _generator(cfg, seed=11, T=FRAMES)
    params = variables["params"]
    jax_walk = _jax_walk_with_the_generators_post_slope(script, cfg, monkeypatch)
    cal = np.random.RandomState(12).randn(1, FRAMES, 80).astype(np.float32)

    # the unquantized walk is the generator (the plain float32 forward)
    with torch.no_grad():
        ref = diagnose_int8.generator_walk(port, torch.from_numpy(mel)).numpy()
        np.testing.assert_allclose(ref, port(torch.from_numpy(mel)).numpy(), atol=1e-6)
    np.testing.assert_allclose(ref, np.asarray(jax_walk(cfg, params, jnp.asarray(mel))), atol=1e-5)

    record, want_record = [], []
    diagnose_int8.generator_walk(port, torch.from_numpy(cal), record=record)
    jax_walk(cfg, params, jnp.asarray(cal), record=want_record)
    assert len(record) == len(want_record) == sum(len(d) * (2 if resblock == "1" else 1)
                                                  for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)
    for got, want in zip(record, want_record):
        for k in ("amax", "rms"):
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
        # jnp.percentile places the 99.9% point in float32 (index 0.999 * (n - 1))
        assert got["p999"] == pytest.approx(want["p999"], rel=1e-4)
        np.testing.assert_allclose(got["per_channel"].numpy(), want["per_channel"], rtol=1e-5)

    # every mode, both sides given the script's calibration
    calib = [{"per_conv": r["amax"] * 1.25, "p999": r["p999"], "per_channel": jnp.asarray(r["per_channel"]) * 1.25}
             for r in want_record]
    port_calib = [{"per_conv": c["per_conv"], "p999": c["p999"],
                   "per_channel": torch.from_numpy(np.array(c["per_channel"]))} for c in calib]
    assert diagnose_int8.VARIANTS.keys() == {"full_static_per_conv", "weights_only", "acts_only_per_conv",
                                             "acts_per_channel", "acts_p999_clip"}
    for name, kw in diagnose_int8.VARIANTS.items():
        got = diagnose_int8.generator_walk(port, torch.from_numpy(mel), calib=port_calib, **kw).numpy()
        want = np.asarray(jax_walk(cfg, params, jnp.asarray(mel), calib=calib, **kw))
        if kw["act_mode"] == "none":
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        else:  # an activation code can flip where the float32 conv sums round apart
            _int8_close(got, want)
        assert diagnose_int8.rel_rms(got, ref) == pytest.approx(script.rel_rms(want, ref), abs=5e-3), name


def test_diagnosis_runs_and_reports_the_route_gap(tiny_generator, tmp_path):
    """The whole tool on the CPU (the static route on K3's plain twin): the
    script's keys, the twin's measured error within the simulation's
    reach, crest factors on trained and random weights."""
    cfg, gen, variables, port, mel, calib = tiny_generator
    ckpt = tmp_path / "hifigan_latest_ckpt.pickle"
    with open(ckpt, "wb") as f:
        pickle.dump({"format": NATIVE_FORMAT, "step": 0, "variables": variables}, f)
    result = diagnose_int8.run(ckpt, tmp_path / "corpus", out=tmp_path, device="cpu",
                               cfg=Config(hifigan=port_config(cfg)))
    assert json.loads((tmp_path / "int8_diagnosis.json").read_text()) == json.loads(json.dumps(result))
    assert sorted(result["rel_rms_vs_f32"]) == sorted(diagnose_int8.VARIANTS)
    assert result["kernel_route"] == "plain twin (CPU)" and not result["kernel_fault"]
    n = len(result["mrf_input_crest_factors"]["per_conv"])
    assert n == len(result["mrf_input_crest_factors_random"]["per_conv"]) == 4 * 10
    assert 0 < result["rel_rms_vs_f32"]["weights_only"] < result["rel_rms_vs_f32"]["full_static_per_conv"] + 1e-3


# ---------------------------------------------------------------------------
# validate_gan and validate_e2e_training.
# ---------------------------------------------------------------------------

GAN_SETS = ["train.batch_size=4", "hifigan.segment_size=512", "hifigan.upsample_initial_channel=16",
            "hifigan.mpd_periods=(2,3)", "hifigan.mpd_base_channels=4", "hifigan.msd_scales=2",
            "hifigan.msd_base_channels=16"]


def test_gan_mcd_probe_matches_jax():
    from viettts_tpu_torch.checkpoint import gan_tree
    from viettts_tpu_torch.config import apply_overrides
    from viettts_tpu_torch.train.hifigan import build_gan

    cfg = apply_overrides(Config(), GAN_SETS)
    state, _ = build_gan(cfg, "cpu", 2e-4)
    got = validate_gan.mcd_probe(cfg, "cpu")(state.gen_params)
    jh = JaxHifiGanConfig(**{f: getattr(cfg.hifigan, f) for f in ("upsample_initial_channel", "resblock_kernel_sizes",
                                                                   "resblock_dilation_sizes", "segment_size")})
    held = jnp.asarray(synth_corpus.heldout_clip()[: 16000 * 2 // 256 * 256])
    mel_fn = JaxMel(JaxDspConfig())
    mel_ref = mel_fn(held[None])
    wav = jax_hifigan.Generator(jh, use_wn=True).apply({"params": gan_tree(state.gen_params)}, mel_ref)
    want = float(jax_mcd(mel_ref, mel_fn(wav[..., 0])))
    assert got == pytest.approx(want, abs=1e-4) and want > 0


def test_validate_gan_runs_on_the_cpu(tmp_path):
    """A 3-step run at tiny widths: the script's result keys, finite losses,
    the checkpoint and the sample WAV; a resumed run continues to 4."""
    result = validate_gan.run(3, corpus_n=6, out=tmp_path, device="cpu", overrides=GAN_SETS)
    assert {"steps", "batch_size", "segment_size", "steps_per_sec", "steps_per_sec_steady", "mel_l1_first50_avg",
            "mel_l1_last_avg", "mel_l1_reduction", "disc_loss_last", "gen_loss_last", "mcd_db_first",
            "mcd_db_last", "ok_mel_l1_decreased_30pct", "ok_losses_finite", "ok_mcd_decreased",
            "gta_finetune_mode", "resumed_from_step", "corpus_clips", "lr_decay_steps", "heldout_probe",
            "history", "mcd_history"} <= set(result)
    assert result["ok_losses_finite"] and result["history"]["step"] == [1, 2, 3] and result["corpus_clips"] == 6
    assert (tmp_path / "gan_sample.wav").stat().st_size > 44
    assert json.loads((tmp_path / "gan_training.json").read_text())["steps"] == 3
    resumed = validate_gan.run(4, resume=True, corpus_n=6, out=tmp_path, device="cpu", overrides=GAN_SETS)
    assert resumed["resumed_from_step"] == 3 and resumed["history"]["step"] == [4]
    assert resumed["lr_decay_steps"] == 819


def test_e2e_criteria_functions_match_the_script():
    script = _script("validate_e2e_training")
    rng = np.random.RandomState(4)
    a = rng.randn(37, 80).astype(np.float32)
    for n in (37, 50, 12, 1):
        np.testing.assert_array_equal(validate_e2e_training.time_align(a, n), script.time_align(a, n))
    b = a + 0.3 * rng.randn(*a.shape).astype(np.float32)
    assert validate_e2e_training.pearson(a, b) == float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    wav = synth_corpus.render_sentence(["ba", "mi", "su"], np.random.RandomState(5))[0].astype(np.float32)
    got = validate_e2e_training.log_mel_of(wav, Config())
    want = script.log_mel_of(wav, script.Config())
    assert got.shape == want.shape and got.shape[1] == 80
    # tonal audio: a float32 DFT leaves a frame's empty high bins near the
    # log-mel clip, where the two front ends part by up to 1e-2 (the GTA
    # tool's test notes it); elsewhere they agree to float32 noise
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert np.mean(np.abs(got - want)) <= 1e-4


@pytest.mark.slow  # ~25 s on one CPU worker: the GAN's full-size discriminators at B=16
def test_tiny_e2e_run_completes_on_the_cpu(tmp_path):
    result = validate_e2e_training.run(2, 2, 2, tiny=True, out=tmp_path, device="cpu")
    assert {"ok_acoustic_loss", "ok_duration", "ok_content", "ok_audio", "duration_mean_abs_rel_err",
            "mel_corr_vs_generator", "acoustic_val_loss_init", "acoustic_val_loss_final"} <= set(result)
    assert np.isfinite(result["acoustic_val_loss_final"]) and (tmp_path / "sample.wav").exists()
    again = validate_e2e_training.run(tiny=True, skip_train=True, out=tmp_path, device="cpu")
    assert again["acoustic_val_loss_init"] == result["acoustic_val_loss_init"]
