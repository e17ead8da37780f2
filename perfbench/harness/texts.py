"""Texts of a traffic mix, made from the run's seed.

Every seed gets the same sizes, in another order, with other words: a size is a number of tokens, taken from
fixed quantiles of a log-normal (``size_grid``); the words that fill it are
drawn from the frozen syllable list ``perfbench/data/words.txt``, and the
last word is chosen so that the text has exactly its size.  A text is one
sentence: lowercase syllables and a full stop, which the program's front end
turns into ``sil w1 ' ' w2 ' ' ... sil sil``, 3 tokens beside its words'.
"""

from __future__ import annotations

import math
import statistics
from pathlib import Path
from typing import List, Sequence

import numpy as np

WORDS_FILE = Path(__file__).resolve().parents[1] / "data" / "words.txt"
OVERHEAD = 3  # leading sil, the full stop's sil, trailing sil
MIN_WORD_TOKENS = 3  # a word of 2 letters and its word-end token


def words() -> List[str]:
    return [w for w in WORDS_FILE.read_text(encoding="utf-8").split("\n") if w and not w.startswith("#")]


def size_grid(n: int, median: float, sigma: float, lo: int, hi: int) -> List[int]:
    """``n`` token counts at the quantiles (i + 1/2) / n of a log-normal of
    ``median`` and ``sigma``, clipped to [lo, hi]."""
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [int(min(hi, max(lo, round(median * math.exp(sigma * v))))) for v in z]


def sentence(rng: np.random.Generator, tokens: int, vocab: Sequence[str]) -> str:
    """One sentence of exactly ``tokens`` tokens (at least 6)."""
    by_len = {}
    for w in vocab:
        by_len.setdefault(len(w) + 1, []).append(w)
    lengths = sorted(by_len)
    budget = tokens - OVERHEAD
    if budget < MIN_WORD_TOKENS:
        raise ValueError(f"a sentence has at least {OVERHEAD + MIN_WORD_TOKENS} tokens, not {tokens}")
    out = []
    while budget > lengths[-1]:
        fits = [w for w in vocab if len(w) + 1 <= budget - MIN_WORD_TOKENS]
        w = fits[rng.integers(len(fits))]
        out.append(w)
        budget -= len(w) + 1
    last = by_len[budget]
    out.append(last[rng.integers(len(last))])
    return " ".join(out) + "."


def shuffled(rng: np.random.Generator, values: Sequence) -> list:
    return [values[i] for i in rng.permutation(len(values))]
