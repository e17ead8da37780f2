"""The bucketed path's frame bucket against JAX's, on the CPU.

JAX's ``_dispatch_decode`` (``viettts_tpu/infer/pipeline.py``) decodes a
batch of padded shape (B, T) at its natural frame bucket unless a larger
bucket of the same shape, at most twice the natural one, has already run
there (``warmup`` or earlier traffic): then it snaps up to the smallest
such bucket.  The vocoder's SAME convs near a row's last kept frame read
decoded frames in the larger bucket and zero padding in the natural one,
so the tail of the audio depends on that choice; the port must make the
same one.

Fixtures as in ``tests/test_torch_pipeline.py``: tiny widths, seeded
numpy weights, prenet dropout off, the float32 vocoder on the plain
routes.  Durations are pinned so that the longest row keeps 126 frames of
its natural 128-frame bucket.  Bars: waveform 1e-3 against JAX (BASELINE
.md), durations 1e-5, mel 1e-4; two CPU replicas against one device 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from viettts_tpu.config import SIL_INDEX, WORD_END_INDEX
from viettts_tpu.infer.pipeline import Synthesizer as JaxSynthesizer
from viettts_tpu_torch.infer import pipeline as torch_pipeline

from test_torch_pipeline import TEXTS, _assert_close, _cfg, _write_checkpoints, port_config

FPS = 16000 / 256  # mel frames a second
SHORT_FRAMES = 126.5  # the longest row's frame total: natural bucket 128, 126 frames kept
SNAP_FRAMES = 200.0  # natural bucket 256 (<= 2 x 128): a later 128-bucket batch snaps to it
FAR_FRAMES = 300.0  # natural bucket 384 (> 2 x 128): no snap


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_snap_ckpts"))


def _pace(port, frames):
    """Seconds a token that give the longest of ``TEXTS`` ``frames`` frames,
    every token but ``sil`` and word ends (zeroed by the postprocessing)
    paced alike."""
    counted = max(sum(t not in (SIL_INDEX, WORD_END_INDEX) for t in port.text_to_token_ids(s)) for s in TEXTS)
    return frames / (counted * FPS)


def _pin(jax_synth, port, seconds):
    """Both sides' duration models replaced by ``seconds`` a token, 0 on
    ``sil``, so a trailing ``sil`` trims nothing (JAX's own tests stub
    ``_predict_durations`` the same way)."""
    if jax_synth is not None:
        jax_synth._predict_durations = lambda _v, b: jnp.where(
            b.phonemes == SIL_INDEX, 0.0, seconds).astype(jnp.float32)
    port.duration_model = lambda batch, **_: torch.where(
        batch.phonemes == SIL_INDEX, 0.0, seconds).float()


def _decoded_frames(port):
    """The frame counts the port's decodes run at, per replica."""
    seen = []
    for model in port.acoustic_models:
        decode = model.inference

        def spy(toks, durs, n_frames, *args, decode=decode, **kw):
            seen.append(n_frames)
            return decode(toks, durs, n_frames, *args, **kw)

        model.inference = spy
    return seen


def _bucket_key(port):
    rows = port.text_to_token_ids(TEXTS[1])
    return 2, torch_pipeline._bucket_tokens(len(rows), port.token_buckets)


def test_snaps_to_a_larger_bucket_that_ran_as_jax_does(ckpt_dir):
    """A 2-text batch of natural bucket 128 after one of bucket 256 at the
    same (B, T): both packages decode 256 frames, and the port's audio is
    JAX's, its tail included (the port's 128-frame decode was ~1e-1 off)."""
    cfg = _cfg(ckpt_dir)
    jax_synth, port = JaxSynthesizer(cfg), torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    seen = _decoded_frames(port)
    for frames in (SNAP_FRAMES, SHORT_FRAMES):
        _pin(jax_synth, port, _pace(port, frames))
        got, want = port.synthesize_batch(TEXTS), jax_synth.synthesize_batch(TEXTS)
    assert seen == [256, 256]
    assert jax_synth._compiled_nf[_bucket_key(port)] == {256}
    kept = max(len(g.mel) for g in got)
    assert kept == 126
    for g, w in zip(got, want):
        _assert_close(g, w)


def test_no_snap_beyond_twice_the_natural_bucket(ckpt_dir):
    """A bucket of more than twice the natural one is not snapped to (JAX:
    ``needed <= f <= 2 * n_frames``): the batch decodes its own bucket,
    which then joins the set, and gives the audio of a fresh Synthesizer."""
    cfg = _cfg(ckpt_dir)
    port, fresh = (torch_pipeline.Synthesizer(port_config(cfg), device="cpu") for _ in range(2))
    seen = _decoded_frames(port)
    _pin(None, port, _pace(port, FAR_FRAMES))
    port.synthesize_batch(TEXTS)
    _pin(None, port, _pace(port, SHORT_FRAMES))
    _pin(None, fresh, _pace(port, SHORT_FRAMES))
    got, want = port.synthesize_batch(TEXTS), fresh.synthesize_batch(TEXTS)
    assert seen == [384, 128]
    assert port._seen_nf[_bucket_key(port)] == {384, 128}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.wave, w.wave)


def test_warmup_covers_jax_frame_buckets(ckpt_dir):
    """``warmup`` runs, per token bucket, the buckets of 4 and 8 frames a
    token and, for each silence clamp, the 2x steps above 8 frames a token,
    as JAX's does; an explicit ``frame_buckets`` pins them."""
    cfg = _cfg(ckpt_dir)
    jax_synth, port = JaxSynthesizer(cfg), torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    seen = _decoded_frames(port)
    jax_seen = []
    jax_synth._decode_mel = lambda _v, toks, frames, n_frames, lengths, rngs: (
        jax_seen.append(n_frames) or jnp.zeros((toks.shape[0], n_frames, cfg.acoustic.mel_dim)))
    jax_synth._vocode = lambda _v, mel: jnp.zeros((mel.shape[0], mel.shape[1] * 256, 1))
    for synth in (jax_synth, port):
        synth.warmup(token_buckets=(32, 64), silence_durations=(0.5,))
    assert seen == jax_seen == [128, 256, 512, 1024, 256, 512, 1024, 2048]
    assert port._seen_nf == {k: v for k, v in jax_synth._compiled_nf.items()}
    seen.clear()
    port.warmup(frame_buckets=(384,), token_buckets=(32,))
    assert seen == [384] and 384 in port._seen_nf[(1, 32)]


def test_sharded_path_snaps_on_the_global_shape(ckpt_dir):
    """Two replicas key the buckets by the padded global (B, T), as JAX's
    mesh does: after a 256-frame batch, the 128-frame batch decodes 256
    frames on both shards and equals the one-device port."""
    cfg = _cfg(ckpt_dir)
    one = torch_pipeline.Synthesizer(port_config(cfg), device="cpu")
    two = torch_pipeline.Synthesizer(port_config(cfg), devices=["cpu", "cpu"])
    seen = _decoded_frames(two)
    for frames in (SNAP_FRAMES, SHORT_FRAMES):
        for synth in (one, two):
            _pin(None, synth, _pace(one, frames))
        want, got = one.synthesize_batch(TEXTS), two.synthesize_batch(TEXTS)
    assert seen == [256, 256, 256, 256]
    assert two._seen_nf == {_bucket_key(two): {256}}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.wave, w.wave, atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.mel, w.mel, atol=1e-5, rtol=0)
