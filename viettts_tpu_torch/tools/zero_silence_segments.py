"""Zero the waveform samples inside silence segments, writing new WAVs
(counterpart of ``viettts_tpu/tools/zero_silence_segments.py``): run before
HiFi-GAN training so that the vocoder learns digital silence for
sil/sp/spn segments.

    python -m viettts_tpu_torch.tools.zero_silence_segments -i CORPUS -o OUT
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from viettts_tpu_torch.audio import read_wav, write_wav
from viettts_tpu_torch.data.textgrid import read_textgrid

SILENCE_MARKS = {"sil", "sp", "spn", ""}


def zero_silence(in_wav: Path, textgrid_path: Path, out_wav: Path) -> None:
    sr, y = read_wav(in_wav)
    if y.ndim > 1:
        y = y[:, 0]
    y = np.array(y, copy=True)
    phones = read_textgrid(textgrid_path)[1].intervals  # tier 1 = phones (MFA convention)
    for seg in phones:
        if seg.text.strip().lower() in SILENCE_MARKS:
            y[int(seg.xmin * sr) : int(seg.xmax * sr)] = 0
    out_wav.parent.mkdir(parents=True, exist_ok=True)
    write_wav(out_wav, y, sr)


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(description="Zero silence segments in a corpus")
    parser.add_argument("-i", "--data-dir", type=Path, default=Path("train_data"))
    parser.add_argument("-o", "--output-dir", type=Path, required=True)
    args = parser.parse_args(argv)
    count = 0
    for tg in sorted(args.data_dir.glob("*.TextGrid")):
        wav = tg.with_suffix(".wav")
        if not wav.exists():
            continue
        zero_silence(wav, tg, args.output_dir / wav.name)
        count += 1
    print(f"wrote {count} silence-zeroed wavs to {args.output_dir}")


if __name__ == "__main__":
    main()
