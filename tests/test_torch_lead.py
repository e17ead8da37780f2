"""The port's single-dispatch lead program against JAX's, on the CPU.

JAX's ``Synthesizer`` sends a row of at most ``single_dispatch_max_tokens``
(64) tokens through one program: durations, their postprocessing, the
decode of ``LEAD_FRAMES_PER_TOKEN`` frames a token of its bucket and the
vocoder (``viettts_tpu/infer/pipeline.py::_lead_fn``).  The port runs the
same chain (eagerly here; on CUDA as one graph replay), so its
``synthesize``, one-text ``synthesize_batch`` and ``stream`` chunk 0 give
JAX's audio with both at their default gate.

Fixtures as in ``tests/test_torch_pipeline.py``: tiny widths, seeded numpy
weights, prenet dropout off, the plain routes (on the CPU both packages
take the lead program only with ``acoustic.fused_decode`` and
``hifigan.fused_inference`` off).  Bars: durations 1e-5, mel 1e-4, wave
1e-3; the port's lead against its own bucketed path 1e-4 on the kept
audio, with durations pinned to 0.08 s a token as JAX's own test pins them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viettts_tpu.config import apply_overrides
from viettts_tpu.infer.pipeline import Synthesizer as JaxSynthesizer
from viettts_tpu_torch.infer import pipeline as torch_pipeline

from test_torch_pipeline import STREAM_TEXT, TEXTS, _assert_close, _cfg, _write_checkpoints, port_config

PINNED_S = 0.08  # seconds a token: a speaking pace, well inside the lead's frame budget


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_lead_ckpts"))


@pytest.fixture(scope="module")
def synths(ckpt_dir):
    """JAX's and the port's Synthesizer at their default lead gate."""
    cfg = _cfg(ckpt_dir)
    jax_synth, port = JaxSynthesizer(cfg), torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    assert jax_synth.single_dispatch_max_tokens == port.single_dispatch_max_tokens == 64
    return jax_synth, port


def _pin_durations(jax_synth, port, seconds):
    """Both sides' duration models replaced by a constant pace (JAX's own
    test stubs ``_durations_traced`` the same way)."""
    if jax_synth is not None:
        jax_synth._durations_traced = lambda _v, b: jnp.full(b.phonemes.shape, seconds, jnp.float32)
    port.duration_model = lambda batch, **_: torch.full(batch.phonemes.shape, seconds)


@pytest.mark.parametrize("silence_duration", [-1.0, 0.2])
def test_lead_program_matches_jax(synths, silence_duration):
    """``_synthesize_single_fused`` on both sides, the silence clamp off
    and at 0.2 s (a traced scalar in both programs)."""
    jax_synth, port = synths
    row = port.text_to_token_ids(TEXTS[1])
    want = jax_synth._synthesize_single_fused(row, silence_duration)
    got = port._synthesize_single_fused(row, silence_duration)
    assert want is not None and got is not None
    _assert_close(got, want)


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("entry", ["synthesize", "synthesize_batch", "stream"])
def test_default_routes_match_jax(synths, entry, text):
    """With both gates at 64, the port's ``synthesize``, one-text
    ``synthesize_batch`` and ``stream`` chunk 0 take the lead program as
    JAX's do and give its audio (the bucketed path was 4.37e-2 off JAX's
    wave on ``TEXTS[1]``)."""
    jax_synth, port = synths
    calls = {
        "synthesize": lambda s: s.synthesize(text),
        "synthesize_batch": lambda s: s.synthesize_batch([text])[0],
        "stream": lambda s: next(iter(s.stream(text))),
    }
    _assert_close(calls[entry](port), calls[entry](jax_synth))


def test_lead_matches_bucketed_on_the_kept_audio(ckpt_dir):
    """The lead program decodes a larger static budget than the bucketed
    path, but the decode is causal: with durations pinned, the kept audio
    and mel of the two paths agree (1e-4), the durations exactly, and
    ``synthesize`` returns the lead's result."""
    port = torch_pipeline.Synthesizer(port_config(_cfg(ckpt_dir)), device="cpu")
    _pin_durations(None, port, PINNED_S)
    row = port.text_to_token_ids("một hai ba bốn năm")
    lead = port._synthesize_single_fused(row, -1.0)
    bucketed = port._synthesize_rows([row])[0]
    assert lead is not None and lead.wave.shape == bucketed.wave.shape
    np.testing.assert_array_equal(lead.durations, bucketed.durations)
    np.testing.assert_allclose(lead.wave, bucketed.wave, atol=1e-4)
    np.testing.assert_allclose(lead.mel, bucketed.mel, atol=1e-4)
    np.testing.assert_array_equal(port.synthesize("một hai ba bốn năm").wave, lead.wave)


def test_overflow_falls_back_on_both_sides(ckpt_dir):
    """0.5 s a token on a 10-word row overflows the 8-frames-a-token
    budget: both sides' lead returns None, and ``synthesize`` takes the
    bucketed path instead, with JAX's audio."""
    cfg = _cfg(ckpt_dir)
    jax_synth, port = JaxSynthesizer(cfg), torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    _pin_durations(jax_synth, port, 0.5)
    row = port.text_to_token_ids(STREAM_TEXT)
    assert jax_synth._synthesize_single_fused(row, -1.0) is None
    assert port._synthesize_single_fused(row, -1.0) is None
    got = port.synthesize(STREAM_TEXT)
    assert got.mel.shape[0] > torch_pipeline.LEAD_FRAMES_PER_TOKEN * 32  # beyond the bucket's budget
    _assert_close(got, jax_synth.synthesize(STREAM_TEXT))


@pytest.mark.parametrize("flags", [["hifigan.fused_inference=true"], ["acoustic.fused_decode=true"]])
def test_cpu_gate_mirrors_jax(ckpt_dir, flags, monkeypatch):
    """On the CPU either fused TPU route turns the lead program off in
    JAX (its interpret-mode kernels would dominate), so the port's is off
    there too: ``synthesize`` takes the bucketed path on both sides."""
    cfg = apply_overrides(_cfg(ckpt_dir), flags)
    port = torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    row = port.text_to_token_ids(TEXTS[1])
    assert JaxSynthesizer(cfg)._synthesize_single_fused(row, -1.0) is None
    assert port._synthesize_single_fused(row, -1.0) is None

    def no_lead(*args):
        raise AssertionError("the lead program ran")

    monkeypatch.setattr(port, "_lead_program", no_lead)
    want = port._synthesize_rows([row])[0]
    np.testing.assert_array_equal(port.synthesize(TEXTS[1]).wave, want.wave)


def test_gate_zero_turns_the_lead_off(ckpt_dir, monkeypatch):
    """``single_dispatch_max_tokens = 0``: ``synthesize``,
    ``synthesize_batch`` and ``stream`` all take the bucketed path."""
    port = torch_pipeline.Synthesizer(port_config(_cfg(ckpt_dir)), device="cpu")
    port.single_dispatch_max_tokens = 0
    ran = []
    monkeypatch.setattr(port, "_lead_program", lambda *a: ran.append(a))
    port.synthesize(TEXTS[0])
    port.synthesize_batch([TEXTS[0]])
    list(port.stream(TEXTS[0]))
    assert ran == []


def test_warmup_runs_the_lead_of_each_short_bucket(ckpt_dir, monkeypatch):
    """``warmup(lead_tokens=64)`` runs the lead program once for each token
    bucket of at most 64 tokens when 1 is a batch size; by default none
    runs on the CPU (JAX skips them on its CPU backend), nor without B=1."""
    port = torch_pipeline.Synthesizer(port_config(_cfg(ckpt_dir)), device="cpu")
    buckets = []
    lead = port._synthesize_single_fused

    def spy(row, silence_duration):
        buckets.append(torch_pipeline._bucket_tokens(len(row), port.token_buckets))
        return lead(row, silence_duration)

    monkeypatch.setattr(port, "_synthesize_single_fused", spy)
    port.warmup(token_buckets=(32, 64, 128))
    port.warmup(batch_sizes=(2,), token_buckets=(32,), lead_tokens=64)
    assert buckets == []
    port.warmup(token_buckets=(32, 64, 128), lead_tokens=64)
    assert buckets == [32, 64]


def test_prenet_masks_are_drawn_once_as_the_bucketed_decode_draws_them(ckpt_dir):
    """With prenet dropout on, the lead program's keep masks are
    ``_decode``'s at the same frame budget (drawn from ``prenet_seed``):
    the same mel as a bucketed decode of that budget, call after call."""
    cfg = _cfg(ckpt_dir)
    cfg = cfg.replace(acoustic=dataclasses.replace(cfg.acoustic, prenet_dropout_at_inference=True))
    port = torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    row = port.text_to_token_ids(TEXTS[0])
    T = torch_pipeline._bucket_tokens(len(row), port.token_buckets)
    n_frames = torch_pipeline._bucket_frames(T * torch_pipeline.LEAD_FRAMES_PER_TOKEN)
    toks, lengths, dur_s = port._durations_for([row], -1.0)
    with torch.inference_mode():
        inputs = (torch.from_numpy(toks).long(), torch.from_numpy(lengths).long(), torch.tensor(-1.0))
        _, mel, _, _ = port._lead_program(*inputs, n_frames)
        _, again, _, _ = port._lead_program(*inputs, n_frames)
        want, _ = port._decode(toks, lengths, dur_s, n_frames=n_frames)
    torch.testing.assert_close(mel, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(again, mel, rtol=0, atol=0)
