"""Synthesis CLI of the PyTorch port (counterpart of
``viettts_tpu/synthesizer.py``): the same flags, plus ``--device``.

Usage:
    python -m viettts_tpu_torch.synthesizer --text "xin chào" --output clip.wav
    python -m viettts_tpu_torch.synthesizer --text "xin chào" --output clip.wav --stream
    python -m viettts_tpu_torch.synthesizer --text-file lines.txt --output-dir out/

There is no device fallback: ``--device cuda`` (the default) fails when no
GPU is available.  A text of at most 64 tokens, and a stream's chunk 0,
take the Synthesizer's single-dispatch lead program (on CUDA a graph,
captured at its first use in the run).
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path


def main(argv=None, default_overrides=()):
    """``default_overrides``: config overrides applied before ``--set`` and
    ``--quality`` (so explicit flags win); the ``vietTTS`` shim defaults
    its parity surface to the float32 vocoder route with them."""
    parser = ArgumentParser(description="Vietnamese TTS (PyTorch/CUDA port)")
    parser.add_argument("--text", type=str, help="text to synthesize")
    parser.add_argument(
        "--text-file", type=Path,
        help="file with one utterance per line (batch mode)",
    )
    parser.add_argument("--output", default=Path("clip.wav"), type=Path)
    parser.add_argument(
        "--output-dir", type=Path, help="output directory for batch mode"
    )
    parser.add_argument("--sample-rate", default=16000, type=int)
    parser.add_argument("--silence-duration", default=-1, type=float)
    parser.add_argument("--lexicon-file", default=None)
    parser.add_argument(
        "--save-mel", type=Path, default=None,
        help="also save the log-mel as .npy",
    )
    parser.add_argument(
        "--stream", action="store_true",
        help="write the wav progressively, one silence-bounded chunk at a "
        "time (Synthesizer.stream)",
    )
    parser.add_argument("--ckpt-dir", default=None, type=Path)
    parser.add_argument("--hifigan-ckpt", default=None, type=Path)
    parser.add_argument(
        "--quality", action="store_true",
        help="float32 vocoder route; equivalent to "
        "--set hifigan.inference_dtype=float32",
    )
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="config override, e.g. --set dsp.sample_rate=16000",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: cuda; no CPU fallback)",
    )
    args = parser.parse_args(argv)

    if not args.text and not args.text_file:
        parser.error("one of --text / --text-file is required")

    import numpy as np

    from viettts_tpu_torch.audio import write_wav
    from viettts_tpu_torch.config import Config, apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer
    from viettts_tpu_torch.text import normalize_text

    cfg = apply_overrides(Config(), list(default_overrides) + args.set)
    if args.quality:
        cfg = apply_overrides(cfg, ["hifigan.inference_dtype=float32"])
    if args.ckpt_dir is not None:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)

    synth = Synthesizer(
        cfg,
        hifigan_ckpt=args.hifigan_ckpt,
        lexicon_file=args.lexicon_file,
        device=args.device,
    )

    if args.text:
        print("Normalized text input:", normalize_text(args.text))
        if args.stream:
            mel = _write_stream(synth, args)
        else:
            result = synth.synthesize(args.text, args.silence_duration)
            print("writing output to file", args.output)
            write_wav(args.output, result.wave, args.sample_rate)
            mel = result.mel
        if args.save_mel is not None:
            np.save(args.save_mel.with_suffix(".npy"), mel)
        return 0

    lines = [
        ln.strip() for ln in args.text_file.read_text().splitlines() if ln.strip()
    ]
    out_dir = args.output_dir or Path("synthesized")
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, result in enumerate(synth.synthesize_batch(lines, args.silence_duration)):
        out = out_dir / f"{i:04d}.wav"
        print("writing", out)
        write_wav(out, result.wave, args.sample_rate)
    return 0


def _write_stream(synth, args):
    """Write ``synth.stream`` chunks to the wav as they arrive (16-bit PCM,
    as ``write_wav``); returns the concatenated mel."""
    import time
    import wave

    import numpy as np

    from viettts_tpu_torch.audio import pcm16

    t0 = time.perf_counter()
    mels = []
    with wave.open(str(args.output), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(args.sample_rate)
        for i, part in enumerate(synth.stream(args.text, args.silence_duration)):
            w.writeframes(pcm16(part.wave).tobytes())
            mels.append(part.mel)
            print(f"chunk {i}: {len(part.wave) / args.sample_rate:.2f} s of audio "
                  f"at t={time.perf_counter() - t0:.2f} s")
    print("wrote", args.output)
    return np.concatenate(mels, axis=0)


if __name__ == "__main__":
    sys.exit(main())
