"""Text front-end of the PyTorch port: normalization, lexicon and phoneme
tokenization (its own copy of ``viettts_tpu/text/frontend.py``; the two
give the same token ids, ``tests/test_torch_frontend.py``).

Pure host-side Python.  Behaviour matches the reference vietTTS front-end
(``synthesizer.py`` normalization and ``nat/text2mel.py`` tokenization) so
token id sequences are identical, which is required for checkpoint parity.

The reference ships a 7893-entry lexicon that is purely character-level
(``word -> its characters``); the out-of-vocabulary fallback below spells
words character by character, which reproduces that lexicon exactly.  A
lexicon file is therefore optional here.
"""

from __future__ import annotations

import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from viettts_tpu_torch.config import (
    ALL_PHONEMES,
    SIL_INDEX,
    SPECIAL_PHONEMES,
    WORD_END_INDEX,
)

_SIL = SPECIAL_PHONEMES[SIL_INDEX]

_PHONEME_TO_ID: Dict[str, int] = {p: i for i, p in enumerate(ALL_PHONEMES)}


def normalize_text(text: str, numbers: bool = True) -> str:
    """Normalize raw text: NFKC, lowercase, punctuation -> silence tokens.

    ``numbers=True`` additionally expands digits into Vietnamese number
    words (``text/numbers.py``) before the punctuation mapping — the
    reference silently drops numeric input (its char-level fallback in
    text2mel.py has no digit phonemes).  Digit-free text is
    normalized identically either way."""
    text = unicodedata.normalize("NFKC", text)
    if numbers:
        from viettts_tpu_torch.text.numbers import expand_numbers

        text = expand_numbers(text)
    text = text.lower().strip()
    text = re.sub(r"[\n.,:]+", f" {_SIL} ", text)
    text = text.replace('"', " ")
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"[.,:;?!]+", f" {_SIL} ", text)
    text = re.sub("[ ]+", " ", text)
    text = re.sub(f"( {_SIL}+)+ ", f" {_SIL} ", text)
    return text.strip()


def load_lexicon(path: str | Path) -> Dict[str, str]:
    """Load a tab-separated ``word\\tp h o n e m e s`` lexicon file."""
    lexicon: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.lower().strip()
            if not line:
                continue
            word, _, phones = line.partition("\t")
            lexicon[word] = phones
    return lexicon


def word_to_phonemes(word: str, lexicon: Optional[Dict[str, str]]) -> List[str]:
    """Phonemize one word: lexicon lookup with character-spelling fallback."""
    if lexicon is not None and word in lexicon:
        return lexicon[word].split()
    return [c for c in word if c in _PHONEME_TO_ID]


def text_to_tokens(
    text: str, lexicon: Optional[Dict[str, str]] = None
) -> List[int]:
    """Convert normalized text into phoneme token ids.

    Output layout: ``sil <word phonemes> <word-end> ... sil`` — a leading and
    trailing silence, with a word-end token after every word.  Words that are
    themselves special phonemes (e.g. an inserted ``sil``) map directly to
    their token id with no word-end marker.
    """
    tokens: List[int] = [SIL_INDEX]
    for word in text.strip().lower().split():
        if word in SPECIAL_PHONEMES:
            tokens.append(_PHONEME_TO_ID[word])
            continue
        tokens.extend(_PHONEME_TO_ID[p] for p in word_to_phonemes(word, lexicon))
        tokens.append(WORD_END_INDEX)
    tokens.append(SIL_INDEX)
    return tokens


def tokens_to_ids(phones: Sequence[str]) -> List[int]:
    """Map phoneme strings to integer ids (the dataset path)."""
    return [_PHONEME_TO_ID[p] for p in phones]


def build_char_lexicon(words: Sequence[str]) -> Dict[str, str]:
    """Build the character-level lexicon used by the reference pipeline.

    Equivalent to the lexicon the reference builds in its MFA-alignment
    notebook: every word maps to its in-vocabulary characters.
    """
    lex = {}
    for word in sorted(set(w.lower().strip() for w in words)):
        if not word:
            continue
        phones = [c for c in word if c in _PHONEME_TO_ID and c != " "]
        if phones:
            lex[word] = " ".join(phones)
    return lex
