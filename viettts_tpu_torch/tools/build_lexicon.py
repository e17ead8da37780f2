"""Build the character-level pronunciation lexicon from a word list
(counterpart of ``viettts_tpu/tools/build_lexicon.py``, on the port's own
text front end).

    python -m viettts_tpu_torch.tools.build_lexicon -i words.txt -o lexicon.txt

The reference ships ``assets/infore/lexicon.txt`` and builds it in its MFA
alignment notebook by spelling each word character-by-character; this tool
reproduces that build from any word list (e.g. the transcript corpus), so
no lexicon asset has to be copied around.
"""

from __future__ import annotations

from pathlib import Path

from viettts_tpu_torch.text.frontend import build_char_lexicon, normalize_text


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(description="Build a char-level lexicon")
    parser.add_argument(
        "-i", "--input", type=Path, required=True,
        help="text file; every whitespace-separated word is an entry",
    )
    parser.add_argument("-o", "--output", type=Path, default=Path("lexicon.txt"))
    args = parser.parse_args(argv)

    words = []
    for line in args.input.read_text(encoding="utf-8").splitlines():
        words.extend(normalize_text(line).split())
    lex = build_char_lexicon(w for w in words if w != "sil")
    with open(args.output, "w", encoding="utf-8") as f:
        for word, phones in sorted(lex.items()):
            f.write(f"{word}\t{phones}\n")
    print(f"wrote {len(lex)} entries to {args.output}")


if __name__ == "__main__":
    main()
