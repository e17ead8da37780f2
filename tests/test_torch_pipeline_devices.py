"""Multi-device serving of the port: ``Synthesizer(devices=[...])`` (the
counterpart of JAX's ``Synthesizer(mesh=...)``) and ``serve
--num-devices``, on the CPU with two replicas on ``cpu``.

* Two replicas equal one device on ``tests/test_pipeline.py``'s five
  texts with prenet dropout off: mels and waves within 1e-5 (the rows of
  each shard are decoded in a batch of another size); each replica runs
  its own decode and vocoder (the plain twins count both).
* Identical rows give identical audio across shards; with prenet dropout
  on, each shard draws its own masks, the same on every call.
* The int8 route calibrates once and every replica uses those scales:
  within 1e-3 rel-RMS of one device.
* ``warmup`` rounds batch sizes up to the device count and runs sharded.
* ``serve --num-devices`` builds ``cuda:0 .. cuda:N-1`` and refuses more
  devices than are visible, or a CPU device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from viettts_tpu.config import apply_overrides
from viettts_tpu_torch import serve
from viettts_tpu_torch.infer import pipeline as torch_pipeline
from viettts_tpu_torch.ops.ar_decoder import ar_decode
from viettts_tpu_torch.ops.mrf import fused_mrf

from test_torch_pipeline import _cfg, _write_checkpoints, port_config

TEXTS = ["một hai ba", "bốn năm", "sáu bảy tám chín", "mười", "xin chào"]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_devices_ckpts"), vocoder_gain=0.5)


def _synth(cfg, **kw):
    return torch_pipeline.Synthesizer(port_config(cfg), **kw)


def _close(got, want, atol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.wave.shape == w.wave.shape and g.mel.shape == w.mel.shape
        np.testing.assert_allclose(g.mel, w.mel, atol=atol, rtol=0)
        np.testing.assert_allclose(g.wave, w.wave, atol=atol, rtol=0)
        np.testing.assert_array_equal(g.durations, w.durations)


def test_two_replicas_match_one_device(ckpt_dir):
    cfg = _cfg(ckpt_dir)
    one = _synth(cfg, device="cpu").synthesize_batch(TEXTS)
    two = _synth(cfg, devices=["cpu", "cpu"])
    assert len(two.acoustic_models) == len(two.generators) == 2
    assert two.acoustic_models[0] is not two.acoustic_models[1]
    ar_decode.plain_calls = fused_mrf.plain_calls = 0
    got = two.synthesize_batch(TEXTS)
    assert ar_decode.plain_calls == 2  # one decode per replica
    assert fused_mrf.plain_calls == 2 * len(cfg.hifigan.upsample_rates)
    _close(got, one)
    # an odd batch pads to the device count; synthesize runs on the first
    # device (both bucketed here: the lead program decodes another budget)
    two.single_dispatch_max_tokens = 0
    _close(two.synthesize_batch(TEXTS[:1]), one[:1])
    _close([two.synthesize(TEXTS[0])], one[:1])


def test_identical_rows_give_identical_audio_across_shards(ckpt_dir):
    synth = _synth(_cfg(ckpt_dir), devices=["cpu", "cpu"])
    res = synth.synthesize_batch([TEXTS[2]] * 4)  # rows 0-1 on shard 0, rows 2-3 on shard 1
    for r in res[1:]:
        np.testing.assert_array_equal(r.wave, res[0].wave)
        np.testing.assert_array_equal(r.mel, res[0].mel)


def test_prenet_dropout_is_seeded_per_shard(ckpt_dir):
    cfg = _cfg(ckpt_dir)
    cfg = cfg.replace(acoustic=dataclasses.replace(cfg.acoustic, prenet_dropout_at_inference=True))
    synth = _synth(cfg, devices=["cpu", "cpu"])
    first = synth.synthesize_batch([TEXTS[2]] * 2)
    again = synth.synthesize_batch([TEXTS[2]] * 2)
    for a, b in zip(first, again):  # the same audio for the same text, call after call
        np.testing.assert_array_equal(a.wave, b.wave)
    assert not np.array_equal(first[0].mel, first[1].mel)  # each shard its own masks


def test_int8_scales_are_shared_by_the_replicas(ckpt_dir):
    cfg = apply_overrides(_cfg(ckpt_dir), ["hifigan.inference_dtype=int8"])
    one = _synth(cfg, device="cpu")
    two = _synth(cfg, devices=["cpu", "cpu"])
    for s in (one, two):
        assert s.calibrate_int8(texts=TEXTS[:2])
    for i, scale in two._act_scales.items():
        torch.testing.assert_close(scale, one._act_scales[i], rtol=0, atol=0)
    got, want = two.synthesize_batch(TEXTS), one.synthesize_batch(TEXTS)
    for g, w in zip(got, want):
        rel = np.sqrt(np.mean((g.wave - w.wave) ** 2) / max(np.mean(w.wave**2), 1e-30))
        assert rel < 1e-3, rel


def test_warmup_pads_to_the_device_count(ckpt_dir, monkeypatch):
    synth = _synth(_cfg(ckpt_dir), devices=["cpu", "cpu"])
    calls = []
    dispatch = synth._dispatch

    def spy(rows, toks, lengths, dur_s, *args):
        calls.append((len(rows), args[0] if args else 0))
        return dispatch(rows, toks, lengths, dur_s, *args)

    monkeypatch.setattr(synth, "_dispatch", spy)
    synth.warmup(batch_sizes=(1, 3, 4), token_buckets=(32,))
    # 1 -> 2 rows and 3, 4 -> 4 rows, one shard per replica, at each of
    # the token bucket's two frame buckets (4 and 8 frames a token)
    assert calls == [(1, 0), (1, 1)] * 2 + [(2, 0), (2, 1)] * 2


def test_devices_argument_is_checked(ckpt_dir):
    cfg = _cfg(ckpt_dir)
    with pytest.raises(TypeError, match="devices="):
        _synth(cfg, device="cpu", devices=["cpu"])
    with pytest.raises(TypeError, match="devices="):
        _synth(cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _synth(cfg, devices=["cpu", "cuda:0"])


def test_serve_num_devices(ckpt_dir, monkeypatch):
    assert serve.serving_devices("cpu", 1) == {"device": "cpu"}
    assert serve.serving_devices("cuda", 1) == {"device": "cuda"}
    visible = torch.cuda.device_count()
    too_many = max(visible + 1, 2)
    with pytest.raises(ValueError, match=f"only {visible} CUDA devices are visible; refusing to serve on fewer"):
        serve.serving_devices("cuda", too_many)
    with pytest.raises(ValueError, match="one device"):
        serve.serving_devices("cpu", 2)
    with pytest.raises(ValueError, match="at least 1"):
        serve.serving_devices("cuda", 0)
    with pytest.raises(ValueError, match="refusing to serve on fewer"):
        serve.build_server(["--ckpt-dir", str(ckpt_dir), "--port", "0", "--num-devices", str(too_many)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert serve.serving_devices("cuda", 3) == {"devices": ["cuda:0", "cuda:1", "cuda:2"]}
