"""Forced alignment tool: corpus assembly + Montreal Forced Aligner
(counterpart of ``viettts_tpu/tools/align.py``, on the port's own text
front end).  A host tool: it runs no model and takes no ``--device``.

The reference runs MFA from a notebook
(``notebooks/align_text_audio_infore_mfa.ipynb``, cells 3-9):
build a word list from the transcripts, spell each word into a
char-level lexicon, run ``mfa train`` over a corpus of ``utt.wav`` +
transcript pairs, then copy the produced TextGrids next to the wavs.
This tool makes that workflow a single runnable command:

    python -m viettts_tpu_torch.tools.align \
        -i raw_corpus -o train_data --lexicon lexicon.txt

* assembles an MFA corpus dir: each ``utt.wav`` is paired with its
  transcript (``utt.txt`` or ``utt.lab``), normalized and written as
  ``utt.lab`` (MFA's preferred transcript extension);
* builds the char-level lexicon from the transcripts (unless an existing
  one is passed) — the phoneme set is the orthography itself, matching
  the reference lexicon build (notebook cell 5);
* invokes ``mfa train`` (or ``mfa align`` with ``--acoustic-model``),
  which must be installed separately (it is an external conda tool in
  the reference workflow too);
* copies the resulting ``*.TextGrid`` files next to the wavs in the
  output dir, ready for ``viettts_tpu_torch.data.loader``.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from viettts_tpu_torch.text.frontend import build_char_lexicon, normalize_text


def assemble_corpus(input_dir: Path, corpus_dir: Path) -> List[str]:
    """Pair ``*.wav`` with transcripts into ``corpus_dir`` and return the
    normalized word list.  Transcripts are looked up as ``utt.lab`` then
    ``utt.txt``; unpaired wavs are skipped with a warning."""
    corpus_dir.mkdir(parents=True, exist_ok=True)
    words: List[str] = []
    n = 0
    for wav in sorted(Path(input_dir).glob("*.wav")):
        txt = None
        for ext in (".lab", ".txt"):
            cand = wav.with_suffix(ext)
            if cand.exists():
                txt = cand
                break
        if txt is None:
            print(f"warning: no transcript for {wav.name}, skipped",
                  file=sys.stderr)
            continue
        text = normalize_text(txt.read_text(encoding="utf-8"))
        # MFA treats the transcript as plain words; drop the sil markers
        # the TTS normalizer inserts for punctuation.
        toks = [w for w in text.split() if w != "sil"]
        words.extend(toks)
        shutil.copy(wav, corpus_dir / wav.name)
        (corpus_dir / (wav.stem + ".lab")).write_text(
            " ".join(toks), encoding="utf-8"
        )
        n += 1
    print(f"assembled {n} utterances into {corpus_dir}")
    return words


def write_lexicon(words, lexicon_file: Path) -> int:
    lex = build_char_lexicon(w for w in words if w)
    with open(lexicon_file, "w", encoding="utf-8") as f:
        for word, phones in sorted(lex.items()):
            f.write(f"{word}\t{phones}\n")
    return len(lex)


def run_mfa(
    corpus_dir: Path,
    lexicon_file: Path,
    textgrid_dir: Path,
    acoustic_model: Optional[str] = None,
    num_jobs: int = 4,
    mfa_binary: str = "mfa",
    extra_args: Optional[List[str]] = None,
) -> None:
    """Invoke MFA.  ``mfa train`` when no acoustic model is given (the
    reference's path, notebook cell 8), else ``mfa align`` with the
    pretrained model."""
    if acoustic_model is None:
        cmd = [
            mfa_binary, "train", "--clean",
            "-j", str(num_jobs),
            str(corpus_dir), str(lexicon_file), str(textgrid_dir),
        ]
    else:
        cmd = [
            mfa_binary, "align", "--clean",
            "-j", str(num_jobs),
            str(corpus_dir), str(lexicon_file), acoustic_model,
            str(textgrid_dir),
        ]
    cmd += list(extra_args or [])
    print("+", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
    except FileNotFoundError:
        raise SystemExit(
            f"'{mfa_binary}' not found — install Montreal Forced Aligner "
            "(conda install -c conda-forge montreal-forced-aligner) or pass "
            "--mfa-binary"
        )


def collect_textgrids(textgrid_dir: Path, output_dir: Path) -> int:
    """Copy produced TextGrids next to the wavs (notebook cell 9).  MFA
    may nest them one directory deep (per-speaker); both layouts are
    handled."""
    output_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for tg in sorted(Path(textgrid_dir).rglob("*.TextGrid")):
        shutil.copy(tg, output_dir / tg.name)
        n += 1
    return n


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(
        description="Assemble an MFA corpus, build the lexicon and align"
    )
    parser.add_argument(
        "-i", "--input-dir", type=Path, required=True,
        help="dir of utt.wav + utt.txt/.lab transcript pairs",
    )
    parser.add_argument(
        "-o", "--output-dir", type=Path, default=Path("train_data"),
        help="where wavs + TextGrids land (the trainers' data_dir)",
    )
    parser.add_argument(
        "--work-dir", type=Path, default=Path("mfa_work"),
        help="scratch dir for the corpus + raw MFA output",
    )
    parser.add_argument(
        "--lexicon", type=Path, default=None,
        help="existing lexicon file (default: build char lexicon here)",
    )
    parser.add_argument(
        "--acoustic-model", default=None,
        help="pretrained MFA acoustic model for `mfa align` "
             "(default: `mfa train` from scratch, like the reference)",
    )
    parser.add_argument("--num-jobs", type=int, default=4)
    parser.add_argument("--mfa-binary", default="mfa")
    parser.add_argument(
        "--skip-mfa", action="store_true",
        help="assemble corpus + lexicon only (no aligner invocation)",
    )
    parser.add_argument(
        "mfa_args", nargs="*",
        help="extra args passed through to mfa",
    )
    args = parser.parse_args(argv)

    corpus_dir = args.work_dir / "corpus"
    textgrid_dir = args.work_dir / "textgrids"
    words = assemble_corpus(args.input_dir, corpus_dir)
    if args.lexicon is not None and args.lexicon.exists():
        lexicon_file = args.lexicon
    else:
        lexicon_file = args.lexicon or (args.work_dir / "lexicon.txt")
        n = write_lexicon(words, lexicon_file)
        print(f"wrote {n}-entry char lexicon to {lexicon_file}")
    if args.skip_mfa:
        return 0
    run_mfa(
        corpus_dir, lexicon_file, textgrid_dir,
        acoustic_model=args.acoustic_model,
        num_jobs=args.num_jobs,
        mfa_binary=args.mfa_binary,
        extra_args=args.mfa_args,
    )
    n = collect_textgrids(textgrid_dir, args.output_dir)
    for wav in corpus_dir.glob("*.wav"):
        shutil.copy(wav, args.output_dir / wav.name)
    print(f"collected {n} TextGrids into {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
