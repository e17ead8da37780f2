"""Dataset loading and batching for MFA-aligned TextGrid + WAV corpora
(counterpart of ``viettts_tpu/data/loader.py``).

The same deterministic shuffle (seed 42) and train/val split over the
sorted TextGrids, the same padded fixed-shape numpy batches drawn in the
same ``np.random.RandomState(seed)`` order, waveforms zeroed inside
special-phoneme segments, and a single-pass "gta" mode with a partial last
batch.  ``prefetch_to_device`` takes the place of the JAX package's
``device_prefetch``: it uploads the next batch through pinned memory,
without blocking, while the current one is in use.
"""

from __future__ import annotations

import collections
import random
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from viettts_tpu_torch.audio import read_wav
from viettts_tpu_torch.config import ALL_PHONEMES, SPECIAL_PHONEMES, DataConfig
from viettts_tpu_torch.data.textgrid import load_alignment
from viettts_tpu_torch.types import AcousticBatch, DurationBatch

_PHONEME_TO_ID = {p: i for i, p in enumerate(ALL_PHONEMES)}
_NUM_SPECIAL = len(SPECIAL_PHONEMES)


def split_files(data_dir: Path, mode: str, cfg: DataConfig = DataConfig()) -> List[Path]:
    """Deterministic train/val split over the corpus TextGrids."""
    tg_files = sorted(Path(data_dir).glob("*.TextGrid"))
    random.Random(cfg.shuffle_seed).shuffle(tg_files)
    n_train = int(len(tg_files) * cfg.train_split)
    if mode == "train":
        return tg_files[:n_train]
    if mode == "val":
        return tg_files[n_train:]
    if mode == "gta":
        return tg_files
    raise ValueError(f"unknown mode {mode!r}")


def _load_tokens(fn: Path, seq_len: int) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """One TextGrid -> (padded ids [L], padded durations [L], length), or
    None when it is longer than ``seq_len``."""
    pairs = load_alignment(fn)
    if len(pairs) > seq_len:
        return None
    ids = np.zeros((seq_len,), np.int32)
    durs = np.zeros((seq_len,), np.float32)
    for i, (ph, d) in enumerate(pairs):
        ids[i] = _PHONEME_TO_ID[ph]
        durs[i] = d
    return ids, durs, len(pairs)


def _shuffled_batches(n: int, batch_size: int, seed: int) -> Iterator[np.ndarray]:
    """Index batches of an endless reshuffled pass, dropping each epoch's
    remainder."""
    rng = np.random.RandomState(seed)
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    while True:
        order = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            yield order[s : s + batch_size]


class DurationDataset:
    """All alignments in RAM as packed arrays; endless shuffled batches."""

    def __init__(self, data_dir: Path, seq_len: int, mode: str, cfg: DataConfig = DataConfig()):
        rows = [r for r in (_load_tokens(f, seq_len) for f in split_files(data_dir, mode, cfg)) if r]
        if not rows:
            raise ValueError(f"no usable TextGrids in {data_dir} ({mode})")
        self.phonemes = np.stack([r[0] for r in rows])
        self.durations = np.stack([r[1] for r in rows])
        self.lengths = np.array([r[2] for r in rows], np.int32)

    def __len__(self) -> int:
        return len(self.lengths)

    def batches(self, batch_size: int, seed: int = 0) -> Iterator[DurationBatch]:
        for idx in _shuffled_batches(len(self), batch_size, seed):
            yield DurationBatch(
                phonemes=self.phonemes[idx], lengths=self.lengths[idx], durations=self.durations[idx]
            )


def _zero_special_segments(
    wav: np.ndarray, ids: np.ndarray, durs: np.ndarray, length: int, sample_rate: int
) -> np.ndarray:
    """Zero the samples inside special-phoneme (sil/sp/spn/word-end)
    segments, so the model never learns breath or noise in silence."""
    wav = np.array(wav, copy=True)
    t = 0.0
    n = len(ids)
    for i in range(n):
        left = int(t * sample_rate)
        t_end = t + float(durs[i])
        right = len(wav) if i == n - 1 else int(t_end * sample_rate)
        if ids[i] < _NUM_SPECIAL:
            wav[left:right] = 0
        t = t_end
    return wav


class AcousticDataset:
    """Alignments + silence-zeroed waveforms in RAM as packed arrays."""

    def __init__(
        self,
        data_dir: Path,
        seq_len: int,
        pad_wav_len: int,
        mode: str,
        cfg: DataConfig = DataConfig(),
        sample_rate: int = 16000,
    ):
        names: List[str] = []
        tok_rows, wav_rows, wav_lens = [], [], []
        for fn in split_files(data_dir, mode, cfg):
            row = _load_tokens(fn, seq_len)
            wav_file = fn.with_suffix(".wav")
            if row is None or not wav_file.exists():
                continue
            sr, y = read_wav(wav_file)
            if y.ndim > 1:
                y = y[:, 0]
            y = _zero_special_segments(y.astype(np.int16), *row, sr)[:pad_wav_len]
            names.append(fn.stem)
            tok_rows.append(row)
            wav_lens.append(len(y))
            wav_rows.append(np.pad(y, (0, pad_wav_len - len(y))))
        if not tok_rows:
            raise ValueError(f"no usable utterances in {data_dir} ({mode})")
        self.names = names
        self.phonemes = np.stack([r[0] for r in tok_rows])
        self.durations = np.stack([r[1] for r in tok_rows])
        self.lengths = np.array([r[2] for r in tok_rows], np.int32)
        self.wavs = np.stack(wav_rows)
        self.wav_lengths = np.array(wav_lens, np.int32)

    def __len__(self) -> int:
        return len(self.lengths)

    def _make_batch(self, idx: np.ndarray) -> AcousticBatch:
        return AcousticBatch(
            phonemes=self.phonemes[idx],
            lengths=self.lengths[idx],
            durations=self.durations[idx],
            wavs=self.wavs[idx],
            wav_lengths=self.wav_lengths[idx],
            mels=None,
        )

    def batches(self, batch_size: int, seed: int = 0) -> Iterator[AcousticBatch]:
        for idx in _shuffled_batches(len(self), batch_size, seed):
            yield self._make_batch(idx)

    def gta_batches(self, batch_size: int) -> Iterator[Tuple[List[str], AcousticBatch]]:
        """One deterministic pass over every utterance, names attached, the
        last batch possibly partial."""
        n = len(self)
        for s in range(0, n, batch_size):
            idx = np.arange(s, min(s + batch_size, n))
            yield [self.names[i] for i in idx], self._make_batch(idx)


def to_device(batch, device: torch.device):
    """A batch NamedTuple (or list of them) of numpy leaves -> the same of
    tensors on ``device``.  On CUDA each leaf goes through pinned memory
    with ``non_blocking=True``, so the copy overlaps the work queued before
    it; the caching host allocator keeps the pinned buffer until the copy
    has run."""
    if isinstance(batch, list):
        return [to_device(b, device) for b in batch]

    def put(a):
        if a is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    return type(batch)(*(put(a) for a in batch))


def prefetch_to_device(it: Iterator, device: torch.device, size: int = 2) -> Iterator:
    """Keep ``size`` batches of ``it`` uploaded ahead (``to_device``)."""
    queue: collections.deque = collections.deque()
    for batch in it:
        queue.append(to_device(batch, device))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
