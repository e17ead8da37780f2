"""Praat TextGrid parser, long and short text formats (counterpart of
``viettts_tpu/data/textgrid.py``), for the MFA alignments the trainers
read: interval tiers of (xmin, xmax, text).

``load_alignment`` walks phones within words as the reference does: it
emits (phoneme, duration_seconds) pairs from the phones tier, a
zero-duration word-end token at every boundary after a non-empty word,
and ``sil`` for empty phone marks.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

from viettts_tpu_torch.config import SPECIAL_PHONEMES, WORD_END_INDEX

_WORD_END = SPECIAL_PHONEMES[WORD_END_INDEX]
_TOKEN = re.compile(r'"(?:[^"]|"")*"|-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?')
# long-format structural lines ("item [1]:", "intervals [7]:") carry
# numbers that are not data
_INDEX_LINE = re.compile(r"^\s*(item|intervals|points)\s*\[\d*\]\s*:\s*$", re.MULTILINE)


@dataclass(frozen=True)
class Interval:
    xmin: float
    xmax: float
    text: str

    @property
    def duration(self) -> float:
        return self.xmax - self.xmin


@dataclass(frozen=True)
class Tier:
    name: str
    intervals: Tuple[Interval, ...]


def parse_textgrid(text: str) -> List[Tier]:
    """Parse a TextGrid document into tiers by scanning its stream of
    quoted strings and numbers (both text formats, any indentation)."""
    tokens = []  # (is_string, value)
    for m in _TOKEN.finditer(_INDEX_LINE.sub("", text)):
        tok = m.group(0)
        tokens.append((True, tok[1:-1].replace('""', '"')) if tok.startswith('"') else (False, tok))
    pos = 0

    def take(want_string: bool):
        nonlocal pos
        while pos < len(tokens) and tokens[pos][0] != want_string:
            pos += 1
        if pos >= len(tokens):
            raise ValueError("unexpected end of TextGrid")
        pos += 1
        return tokens[pos - 1][1]

    def next_str() -> str:
        return take(True)

    def next_num() -> float:
        return float(take(False))

    ftype, oclass = next_str(), next_str()  # "ooTextFile", "TextGrid"
    if "TextGrid" not in oclass and "TextGrid" not in ftype:
        raise ValueError("not a TextGrid file")
    next_num(), next_num()  # xmin, xmax
    tiers: List[Tier] = []
    for _ in range(int(next_num())):
        tclass, name = next_str(), next_str()
        next_num(), next_num()  # the tier's xmin, xmax
        n = int(next_num())
        intervals = []
        for _i in range(n):
            if tclass == "IntervalTier":
                xmin, xmax = next_num(), next_num()
                intervals.append(Interval(xmin, xmax, next_str()))
            else:  # point tier: (time, mark)
                t = next_num()
                intervals.append(Interval(t, t, next_str()))
        tiers.append(Tier(name=name, intervals=tuple(intervals)))
    return tiers


def read_textgrid(path: str | Path) -> List[Tier]:
    raw = Path(path).read_bytes()
    for enc in ("utf-8", "utf-16"):
        try:
            return parse_textgrid(raw.decode(enc))
        except UnicodeDecodeError:
            continue
    raise ValueError(f"cannot decode TextGrid file {path}")


def _phone_in_word(phone: Interval, word: Interval, tol: float = 1e-3) -> bool:
    return (
        word.xmin - tol < phone.xmin < word.xmax + tol
        and word.xmin - tol < phone.xmax < word.xmax + tol
    )


def load_alignment(path: str | Path) -> List[Tuple[str, float]]:
    """MFA TextGrid (tier 0 words, tier 1 phones) -> [(phoneme,
    duration_seconds)] with word-end markers."""
    tiers = read_textgrid(path)
    if len(tiers) < 2:
        raise ValueError(f"expected words+phones tiers in {path}")
    words, phones = list(tiers[0].intervals), list(tiers[1].intervals)
    if not phones or abs(phones[0].xmin) > 1e-6:
        raise ValueError("The first phoneme has to start at time 0")
    data: List[Tuple[str, float]] = []
    widx = 0
    for p in phones:
        if not _phone_in_word(p, words[widx]):
            widx += 1
            if len(words[widx - 1].text.strip()) > 0:
                data.append((_WORD_END, 0.0))
            if widx >= len(words):
                break
            if not _phone_in_word(p, words[widx]):
                raise ValueError(f"mismatched word vs phoneme in {path}")
        mark = p.text.strip().lower()
        data.append((mark or "sil", p.duration))
    return data
