"""Plain reference of the text front end: text -> token ids.

Written from the reference vietTTS's rules (``synthesizer.py``'s
normalization, ``nat/text2mel.py``'s tokenization with its character-level
lexicon): NFKC, lowercase, ``. , :`` ``; ? !`` and newlines become a
silence word, every other word is spelled letter by letter and followed by a
word-end token, and the whole is framed by silences.  The token ids are the
phoneme ABI of the checkpoints (special phonemes, then the 89 letters of
Vietnamese orthography), copied here.  Digits are out of scope: the
benchmark's texts have none, and a text with one is refused.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List

SPECIAL = ("sil", "sp", "spn", " ")
LETTERS = (
    "abcdeghiklmnopqrstuvxy"
    "àáâãèéêìíòóôõùúýăđĩũơư"
    "ạảấầẩẫậắằẳẵặẹẻẽếềểễệỉịọỏốồổỗộớờởỡợụủứừửữựỳỵỷỹ"
)
IDS = {p: i for i, p in enumerate(SPECIAL + tuple(LETTERS))}
SIL, WORD_END = IDS["sil"], IDS[" "]


def tokens(text: str) -> List[int]:
    text = unicodedata.normalize("NFKC", text)
    if any(c.isdigit() for c in text):
        raise ValueError("the reference front end reads no digits")
    text = text.lower().strip()
    text = re.sub(r"[\n.,:;?!]+", " sil ", text.replace('"', " "))
    out = [SIL]
    last_sil = False
    for word in text.split():
        if word == "sil":
            if not last_sil:  # runs of punctuation make one silence
                out.append(SIL)
            last_sil = True
            continue
        last_sil = False
        out.extend(IDS[c] for c in word if c in IDS and c != " ")
        out.append(WORD_END)
    out.append(SIL)
    return out
