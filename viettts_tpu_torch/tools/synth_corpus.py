"""The two synthetic corpora of the validation tools, rendered from a seed
(counterparts of the corpus functions of ``scripts/validate_e2e_training.py``
and ``scripts/validate_gan.py``, which give the same bytes from the same
seed).

* The aligned phoneme corpus (``build_corpus``): each vowel a harmonic tone
  at its own pitch, the consonants noise bursts or a hum, per-phoneme mean
  durations with jitter, and MFA-style TextGrids (words and phones tiers)
  beside each WAV, plus a lexicon.  The duration, acoustic and GAN trainers
  learn it from scratch (``tools.validate_e2e_training``).
* The GAN corpus (``synth_corpus``): speech-like clips of voiced harmonics
  with a moving f0, syllabic envelopes, pauses and noise bursts, drawn in
  sequence from one seed-0 stream, so a larger corpus extends a smaller
  one; ``heldout_clip`` is a clip of the same kind from a stream the corpus
  never touches (``tools.validate_gan``, ``tools.validate_int8``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from viettts_tpu_torch.audio import write_wav

SR = 16000

# --- the aligned phoneme corpus -------------------------------------------

VOWELS = {"a": 240.0, "e": 360.0, "i": 480.0, "o": 600.0, "u": 720.0}
CONSONANTS = ("b", "m", "t", "s")
DUR_MEAN = {**{v: 0.18 for v in VOWELS}, "b": 0.08, "m": 0.10, "t": 0.06, "s": 0.09}
WORDS = [c + v for c in CONSONANTS for v in VOWELS] + ["bami", "tasu", "mibo", "sute", "bota", "misa"]
HELD_OUT = "ba mi su to ma se bu ti"  # words never adjacent this way in the corpus


def render_phoneme(ph: str, dur_s: float, rng: np.random.RandomState) -> np.ndarray:
    """One phoneme's float64 samples: a vowel's three harmonics with a 20 ms
    attack and release, ``s`` high-band noise, ``t`` a click with a noise
    tail, ``b``/``m`` a decaying low hum."""
    n = int(round(dur_s * SR))
    t = np.arange(n) / SR
    if ph in VOWELS:
        f0 = VOWELS[ph]
        sig = sum((0.5 / h) * np.sin(2 * np.pi * f0 * h * t) for h in (1, 2, 3))
        env = np.minimum(1.0, np.minimum(t, t[::-1] + 1e-9) / 0.02)
        return (sig * env).astype(np.float64)
    if ph == "s":
        return 0.25 * np.convolve(rng.randn(n), [1, -0.95], mode="same")
    if ph == "t":
        return 0.5 * rng.randn(n) * np.exp(-t / 0.015)
    return 0.4 * np.sin(2 * np.pi * 120.0 * t) * np.exp(-t / 0.08)


def render_sentence(words, rng: np.random.RandomState, jitter: float = 0.15):
    """words -> (float64 waveform peaking at 0.7, intervals [(phoneme,
    seconds)] with leading, trailing and some inter-word silences)."""
    intervals = [("sil", 0.15 + 0.1 * rng.rand())]
    for k, w in enumerate(words):
        for ph in w:
            intervals.append((ph, DUR_MEAN[ph] * (1.0 + jitter * (2 * rng.rand() - 1))))
        if k < len(words) - 1 and rng.rand() < 0.3:
            intervals.append(("sil", 0.1 + 0.1 * rng.rand()))
    intervals.append(("sil", 0.15 + 0.1 * rng.rand()))
    parts = [np.zeros(int(round(d * SR))) if ph == "sil" else render_phoneme(ph, d, rng) for ph, d in intervals]
    wav = np.concatenate(parts)
    return 0.7 * wav / max(np.abs(wav).max(), 1e-6), intervals


def textgrid_for(words, intervals) -> str:
    """A long-format TextGrid whose words and phones tiers agree."""

    def fmt(items):
        rows, t = [], 0.0
        for i, (text, d) in enumerate(items):
            rows.append(f"        intervals [{i + 1}]:\n            xmin = {t:.6f}\n"
                        f"            xmax = {t + d:.6f}\n            text = \"{text}\"\n")
            t += d
        return "".join(rows), t

    word_items, i, wi = [], 0, 0
    while i < len(intervals):
        if intervals[i][0] == "sil":
            word_items.append(("", intervals[i][1]))
            i += 1
            continue
        span = 0.0
        for ph in words[wi]:
            if intervals[i][0] != ph:
                raise ValueError(f"word {words[wi]!r} does not match interval {intervals[i]}")
            span += intervals[i][1]
            i += 1
        word_items.append((words[wi], span))
        wi += 1
    ptxt, total = fmt(intervals)
    wtxt, total_w = fmt(word_items)
    if abs(total - total_w) >= 1e-6:
        raise ValueError(f"tiers end at {total} and {total_w}")
    tier = '        class = "IntervalTier"\n        name = "{}"\n        xmin = 0\n        xmax = {:.6f}\n'
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
            f"xmin = 0\nxmax = {total:.6f}\ntiers? <exists>\nsize = 2\nitem []:\n"
            "    item [1]:\n" + tier.format("words", total) + f"        intervals: size = {len(word_items)}\n{wtxt}"
            "    item [2]:\n" + tier.format("phones", total) + f"        intervals: size = {len(intervals)}\n{ptxt}")


def build_corpus(d: Path, n_utts: int = 64, seed: int = 0) -> None:
    """``uttNNN.wav`` + ``uttNNN.TextGrid`` for ``n_utts`` sentences of 3-6
    corpus words, and ``lexicon.txt`` (each word spelled by its letters)."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n_utts):
        words = [WORDS[rng.randint(len(WORDS))] for _ in range(rng.randint(3, 7))]
        wav, intervals = render_sentence(words, rng)
        write_wav(d / f"utt{i:03d}.wav", wav.astype(np.float32), SR)
        (d / f"utt{i:03d}.TextGrid").write_text(textgrid_for(words, intervals))
    lex = "\n".join(f"{w}\t{' '.join(w)}" for w in sorted(set(WORDS)))
    (d / "lexicon.txt").write_text(lex + "\n")


# --- the GAN corpus ---------------------------------------------------------


def _synth_clip(rng: np.random.RandomState, t: np.ndarray) -> np.ndarray:
    """One speech-like clip: voiced harmonics with a moving f0, a 3-6 Hz
    syllabic envelope, pauses, and unvoiced noise bursts; peak 0.6."""
    f0 = 90 + 60 * rng.rand() + 30 * np.sin(2 * np.pi * (0.5 + rng.rand()) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum((0.6 / h) * np.sin(h * phase + rng.rand() * 6.28) for h in range(1, 9))
    env = np.clip(np.sin(2 * np.pi * (3 + 3 * rng.rand()) * t + rng.rand() * 6), 0, None)
    gate = (np.sin(2 * np.pi * 0.7 * t + rng.rand() * 6) > -0.4).astype(np.float64)
    sig = voiced * env * gate
    noise = rng.randn(len(t)) * 0.15
    burst = (np.sin(2 * np.pi * 1.3 * t + rng.rand() * 6) > 0.8).astype(np.float64)
    sig = sig + noise * burst
    return 0.6 * sig / max(np.abs(sig).max(), 1e-6)


def synth_corpus(d: Path, n: int = 48, seconds: float = 2.0) -> None:
    """``synNNN.wav`` for the first ``n`` clips of the seed-0 stream; files
    that exist are kept (the stream is drawn in full either way)."""
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    t = np.arange(int(SR * seconds)) / SR
    for i in range(n):
        out = d / f"syn{i:03d}.wav"
        clip = _synth_clip(rng, t).astype(np.float32)
        if not out.exists():
            write_wav(out, clip, SR)


def heldout_clip(seconds: float = 2.0) -> np.ndarray:
    """A clip of the corpus's kind from the seed-12345 stream, which the
    corpus never draws from."""
    rng = np.random.RandomState(12345)
    t = np.arange(int(SR * seconds)) / SR
    return _synth_clip(rng, t).astype(np.float32)
