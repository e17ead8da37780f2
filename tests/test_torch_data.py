"""The port's corpus reading (``read_wav``, TextGrids, the loaders)
against the JAX package's, on a synthetic aligned corpus built by
``scripts/validate_e2e_training.py::build_corpus``: every array equal, and
the first batches of one seed equal batch for batch."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from viettts_tpu.config import DataConfig as JaxDataConfig
from viettts_tpu.data import audio as jax_audio
from viettts_tpu.data import loader as jax_loader
from viettts_tpu.data import textgrid as jax_textgrid
from viettts_tpu_torch import audio
from viettts_tpu_torch.config import DataConfig
from viettts_tpu_torch.data import loader, textgrid

REPO = Path(__file__).resolve().parents[1]
SEQ_LEN, WAVE_LEN = 64, 65_536

SHORT_FORMAT = '''File type = "ooTextFile"
Object class = "TextGrid"

0
1.5
<exists>
2
"IntervalTier"
"words"
0
1.5
2
0
0.9
"xin"
0.9
1.5
""
"IntervalTier"
"phones"
0
1.5
4
0
0.3
"x"
0.3
0.6
"I"
0.6
0.9
"n"
0.9
1.5
""
'''


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from validate_e2e_training import build_corpus
    finally:
        sys.path.remove(str(REPO / "scripts"))
    d = tmp_path_factory.mktemp("corpus")
    build_corpus(d, n_utts=24, seed=1)
    return d


def test_read_wav_matches_jax(corpus):
    for path in sorted(corpus.glob("*.wav"))[:4]:
        sr, got = audio.read_wav(path)
        want_sr, want = jax_audio.read_wav(path)
        assert sr == want_sr == 16000 and got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)


def test_textgrids_parse_like_jax(corpus):
    for path in sorted(corpus.glob("*.TextGrid"))[:6]:
        text = path.read_text()
        got, want = textgrid.parse_textgrid(text), jax_textgrid.parse_textgrid(text)
        assert [(t.name, [(i.xmin, i.xmax, i.text) for i in t.intervals]) for t in got] == [
            (t.name, [(i.xmin, i.xmax, i.text) for i in t.intervals]) for t in want
        ]
        assert textgrid.load_alignment(path) == jax_textgrid.load_alignment(path)


def test_short_format_and_quotes_parse_like_jax(tmp_path):
    text = SHORT_FORMAT.replace('"I"', '"say ""i"""')
    got, want = textgrid.parse_textgrid(text), jax_textgrid.parse_textgrid(text)
    assert [[(i.xmin, i.xmax, i.text) for i in t.intervals] for t in got] == [
        [(i.xmin, i.xmax, i.text) for i in t.intervals] for t in want
    ]
    assert got[1].intervals[1].text == 'say "i"'
    path = tmp_path / "short.TextGrid"
    path.write_text(SHORT_FORMAT, encoding="utf-16")
    assert textgrid.load_alignment(path) == jax_textgrid.load_alignment(path)
    assert textgrid.load_alignment(path)[-2:] == [(" ", 0.0), ("sil", 0.6)]


@pytest.mark.parametrize("mode", ["train", "val", "gta"])
def test_split_files_match_jax(corpus, mode):
    assert loader.split_files(corpus, mode, DataConfig()) == jax_loader.split_files(corpus, mode, JaxDataConfig())


def _assert_batches_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
        else:
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def test_duration_dataset_matches_jax(corpus):
    got = loader.DurationDataset(corpus, SEQ_LEN, "train", DataConfig())
    want = jax_loader.DurationDataset(corpus, SEQ_LEN, "train", JaxDataConfig())
    for field in ("phonemes", "durations", "lengths"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    for g, w in zip(got.batches(5, seed=42), [b for b, _ in zip(want.batches(5, seed=42), range(3))]):
        _assert_batches_equal(g, w)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_acoustic_dataset_matches_jax(corpus, mode):
    got = loader.AcousticDataset(corpus, SEQ_LEN, WAVE_LEN, mode, DataConfig())
    want = jax_loader.AcousticDataset(corpus, SEQ_LEN, WAVE_LEN, mode, JaxDataConfig())
    assert got.names == want.names
    for field in ("phonemes", "durations", "lengths", "wavs", "wav_lengths"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    n = min(4, len(got))
    batches = zip(got.batches(n, seed=7), want.batches(n, seed=7))
    for _, (g, w) in zip(range(3), batches):
        _assert_batches_equal(g, w)
    for (gn, g), (wn, w) in zip(got.gta_batches(3), want.gta_batches(3)):
        assert gn == wn
        _assert_batches_equal(g, w)


def test_silence_segments_are_zeroed_like_jax():
    rng = np.random.RandomState(0)
    wav = rng.randint(-3000, 3000, 8000).astype(np.int16)
    ids = np.asarray([0, 10, 3, 12, 0, 0], np.int32)
    durs = np.asarray([0.05, 0.1, 0.0, 0.2, 0.1, 0.0], np.float32)
    got = loader._zero_special_segments(wav, ids, durs, 5, 16000)
    np.testing.assert_array_equal(got, jax_loader._zero_special_segments(wav, ids, durs, 5, 16000))
    assert (got[:800] == 0).all() and (got[800:2400] == wav[800:2400]).all()


def test_prefetch_uploads_batches_in_order(corpus):
    ds = loader.DurationDataset(corpus, SEQ_LEN, "train", DataConfig())
    want = [b for b, _ in zip(ds.batches(4, seed=3), range(3))]
    got = list(loader.prefetch_to_device(iter(want), torch.device("cpu")))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert isinstance(g.phonemes, torch.Tensor)
        for field in w._fields:
            np.testing.assert_array_equal(getattr(g, field).numpy(), getattr(w, field))
