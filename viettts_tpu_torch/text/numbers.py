"""Vietnamese number verbalization for the text front-end (the port's copy
of ``viettts_tpu/text/numbers.py``).

The reference's char-level lexicon contains no digits, so numeric input
is silently dropped from the synthesized speech (its ``nat/text2mel.py``
falls back to character spelling and digits are not phonemes).  This module expands numbers into
standard Vietnamese number words before tokenization:

* integers with standard reading rules — ``mười lăm``, ``hai mươi mốt``,
  ``một trăm linh năm``, ``một nghìn không trăm linh hai`` …
* dot-grouped thousands (``1.234.567``) and decimal commas (``3,5`` ->
  ``ba phẩy năm``), both of which would otherwise be split apart by the
  punctuation -> silence normalization.

Runs before punctuation mapping in ``normalize_text``; digit-free text is
returned unchanged, so the reference-parity surface is unaffected.
"""

from __future__ import annotations

import re

_DIGITS = [
    "không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy", "tám", "chín",
]
_SCALES = ["", " nghìn", " triệu", " tỷ", " nghìn tỷ", " triệu tỷ"]


def _three_digits(n: int, leading: bool) -> str:
    """Read 0..999.  ``leading`` marks the most-significant group, which
    omits the ``không trăm`` filler (1005 = "một nghìn KHÔNG TRĂM linh
    năm", but 5 alone = "năm")."""
    h, rem = divmod(n, 100)
    t, u = divmod(rem, 10)
    parts = []
    if h or not leading:
        parts.append(f"{_DIGITS[h]} trăm")
    if t == 0:
        if u and (h or not leading):
            parts.append("linh")
        if u:
            parts.append(_DIGITS[u])
    elif t == 1:
        parts.append("mười")
        if u == 5:
            parts.append("lăm")
        elif u:
            parts.append(_DIGITS[u])
    else:
        parts.append(f"{_DIGITS[t]} mươi")
        if u == 1:
            parts.append("mốt")
        elif u == 4:
            parts.append("tư")
        elif u == 5:
            parts.append("lăm")
        elif u:
            parts.append(_DIGITS[u])
    return " ".join(parts)


def number_to_vietnamese(n: int) -> str:
    """Integer -> Vietnamese words (standard northern reading)."""
    if n < 0:
        return "âm " + number_to_vietnamese(-n)
    if n == 0:
        return _DIGITS[0]
    if n >= 1000 ** len(_SCALES):
        # beyond the named scales: read digit by digit
        return _read_digit_string(str(n))
    groups = []
    while n:
        n, g = divmod(n, 1000)
        groups.append(g)
    parts = []
    top = len(groups) - 1
    for i in range(top, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        parts.append(_three_digits(g, leading=(i == top)) + _SCALES[i])
    return " ".join(parts)


_DECIMAL_RE = re.compile(r"(?<![\d.,])(\d+),(\d+)(?![\d.,])")
_GROUPED_RE = re.compile(r"(?<![\d.,])(\d{1,3})((?:\.\d{3})+)(?![\d.,])")
_INT_RE = re.compile(r"(?<![\d.,])(\d+)(?![\d.,])")


def _read_digit_string(s: str) -> str:
    return " ".join(_DIGITS[int(c)] for c in s)


def expand_numbers(text: str) -> str:
    """Replace numeric substrings with their Vietnamese reading.

    Handles, in order: decimal commas (``3,5`` -> "ba phẩy năm"),
    dot-grouped thousands (``1.234.567``), and plain integers.  Very long
    plain digit runs (>15 digits, e.g. phone numbers) are read digit by
    digit.  Digit-free text is returned unchanged."""
    if not any(c.isdigit() for c in text):
        return text

    def decimal(m: re.Match) -> str:
        whole, frac = m.group(1), m.group(2)
        return (
            f"{number_to_vietnamese(int(whole))} phẩy "
            + (
                _read_digit_string(frac)
                if len(frac) > 2 or frac.startswith("0")
                else number_to_vietnamese(int(frac))
            )
        )

    def grouped(m: re.Match) -> str:
        return number_to_vietnamese(int(m.group(0).replace(".", "")))

    def integer(m: re.Match) -> str:
        s = m.group(1)
        if len(s) > 15 or (len(s) > 1 and s.startswith("0")):
            return _read_digit_string(s)
        return number_to_vietnamese(int(s))

    text = _DECIMAL_RE.sub(decimal, text)
    text = _GROUPED_RE.sub(grouped, text)
    text = _INT_RE.sub(integer, text)
    # Fallback: anything the structured patterns did not match (ambiguous
    # dot decimals like "3.5", malformed groupings like "12.34") would
    # otherwise pass through and be silently dropped at tokenization — the
    # exact failure this module exists to prevent.  Read leftover digit
    # runs digit-by-digit, treating an embedded dot as the decimal mark.
    def leftover(m: re.Match) -> str:
        s = m.group(0)
        if "." in s:
            whole, _, frac = s.partition(".")
            out = number_to_vietnamese(int(whole)) if whole else ""
            if frac:
                frac_words = " phẩy " + _read_digit_string(
                    frac.replace(".", "")
                )
            else:
                frac_words = ""
            return (out + frac_words).strip()
        return _read_digit_string(s)

    text = re.sub(r"\d+(?:\.\d+)*", leftover, text)
    return text
