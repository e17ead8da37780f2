"""Plain reference of what the serving path derives around the models:
padding, chunking, frame budgets and the kept length of each row.

Written from the JAX pipeline's rules (``viettts_tpu/infer/pipeline.py``,
which the port keeps because its outputs depend on them):

* a batch of n texts is padded with one-token silent rows to a power of
  two, and its tokens to the first token bucket that holds its longest row;
* a one-text batch of at most ``LEAD_MAX_TOKENS`` tokens, and a stream's
  first chunk, take the lead program: ``bucket_frames(T * 8)`` frames
  decoded at once, unless the frame total overflows them;
* every other dispatch decodes a frame bucket (``FrameBuckets``): its
  natural bucket (multiple of 128 holding every row) if that shape has run
  it before, else the smallest bucket that shape has run, holds every row
  and is at most twice the natural one, else the natural one, which then
  joins the shape's set;
* a row keeps ``int(total frames)`` frames, less its trailing silence's;
* a stream cuts its tokens at silences, else at word ends, the first chunk
  at ``lead_tokens`` and the others at ``max_tokens``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from perfbench.reference.frontend import SIL, WORD_END

TOKEN_BUCKETS = (32, 64, 128, 192, 256, 384, 512)
FRAME_BUCKET = 128
LEAD_FRAMES_PER_TOKEN = 8
LEAD_MAX_TOKENS = 64
MAX_TOKENS = 256  # data.max_phoneme_seq_len


def bucket_tokens(n: int, buckets: Sequence[int] = TOKEN_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


def bucket_frames(n: int) -> int:
    return max(FRAME_BUCKET, -(-n // FRAME_BUCKET) * FRAME_BUCKET)


def batch_rows(n: int) -> int:
    """Rows of a padded batch of ``n`` texts."""
    b = 1
    while b < n:
        b *= 2
    return b


def warmup_frame_buckets(tb: int) -> List[int]:
    """The frame buckets a warm-up without explicit ones (and without
    silence clamps) runs for token bucket ``tb``: 4 and 8 frames a token."""
    return sorted({bucket_frames(tb * 4), bucket_frames(tb * 8)})


def frame_totals(durations: Sequence[np.ndarray], T: int, fps: float) -> np.ndarray:
    """Each row's frame total as the host sums it: float32 seconds, zero
    past the row, times the frame rate, summed over the padded row."""
    dur = np.zeros((len(durations), T), np.float32)
    for i, d in enumerate(durations):
        dur[i, :len(d)] = d
    return (dur * fps).sum(axis=1)


class FrameBuckets:
    """The frame buckets each padded (rows, token bucket) shape has run."""

    def __init__(self):
        self.seen: Dict[Tuple[int, int], Set[int]] = {}

    def add(self, shape: Tuple[int, int], n_frames: int) -> None:
        self.seen.setdefault(shape, set()).add(int(n_frames))

    def pick(self, shape: Tuple[int, int], totals: np.ndarray) -> int:
        needed = int(np.max(totals)) + 1
        natural = bucket_frames(needed)
        seen = self.seen.setdefault(shape, set())
        if natural not in seen:
            snap = [f for f in seen if needed <= f <= 2 * natural]
            if snap:
                return min(snap)
            seen.add(natural)
        return natural


def kept_frames(row: Sequence[int], total: float, last_duration: float, fps: float) -> int:
    keep = int(total)
    if row and row[-1] == SIL:
        keep = max(keep - int(np.float32(last_duration) * np.float32(fps)), 1)
    return keep


def _cut_once(rest: List[int], limit: int) -> Tuple[List[int], List[int]]:
    if len(rest) <= limit:
        return rest, []
    for i in range(limit - 1, 0, -1):
        if rest[i] == SIL:
            return rest[:i + 1], rest[i:]
    cut = None
    for i in range(limit - 2, 0, -1):
        if rest[i] == WORD_END:
            cut = i
            break
    if cut is None:
        cut = limit - 2
    return rest[:cut + 1] + [SIL], [SIL] + rest[cut + 1:]


def chunks(tokens: List[int], max_tokens: int = MAX_TOKENS, first: Optional[int] = None) -> List[List[int]]:
    out, rest = [], list(tokens)
    limit = min(first or max_tokens, max_tokens)
    while True:
        chunk, rest = _cut_once(rest, limit)
        out.append(chunk)
        if not rest:
            return out
        limit = max_tokens
