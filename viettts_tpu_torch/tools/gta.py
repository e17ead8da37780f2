"""GTA (ground-truth-aligned) mel export for vocoder finetuning
(counterpart of ``viettts_tpu/tools/gta.py``): the teacher-forced acoustic
model in eval mode over the whole corpus, each utterance's mel after the
postnet saved as ``<name>.npy`` [mel_dim, n_frames], trimmed to
``wav_len // hop`` frames.

    python -m viettts_tpu_torch.tools.gta -o GTA --data-dir CORPUS --ckpt-dir CKPTS [--set K=V ...] [--device cpu]
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from viettts_tpu_torch.checkpoint import load_acoustic, load_variables
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.data.loader import AcousticDataset, to_device
from viettts_tpu_torch.models.acoustic import AcousticModel
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.train.acoustic import prepare_batch
from viettts_tpu_torch.train.common import resolve_device


@torch.no_grad()
def generate_gta(out_dir: Path, cfg: Config = Config(), acoustic_ckpt=None, device="cuda") -> int:
    """Write one GTA mel per utterance of ``cfg.data_dir``; returns the
    count.  With ``prenet_dropout_at_inference`` the prenet's masks are
    drawn from a generator seeded 42."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    device = resolve_device(device)
    hop = cfg.dsp.hop_length
    model = AcousticModel(cfg.acoustic)
    load_acoustic(model, load_variables(acoustic_ckpt or Path(cfg.ckpt_dir) / "acoustic_latest_ckpt.pickle", "acoustic"))
    model.to(device)
    mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
    ds = AcousticDataset(cfg.data_dir, cfg.data.max_phoneme_seq_len, cfg.data.max_wave_len, "gta", cfg.data,
                         cfg.dsp.sample_rate)
    rng = torch.Generator(device).manual_seed(42)
    count = 0
    for names, batch in ds.gta_batches(cfg.train.batch_size):
        model_batch, _ = prepare_batch(to_device(batch, device), mel_fn, hop)
        _, mel, _ = model(model_batch, train=False, generator=rng)
        mel = mel.float().cpu().numpy()
        for i, name in enumerate(names):
            n_frames = int(batch.wav_lengths[i]) // hop
            np.save(out_dir / f"{name}.npy", mel[i, :n_frames].T)
            count += 1
    return count


def main(argv=None):
    from argparse import ArgumentParser

    from viettts_tpu_torch.config import apply_overrides

    parser = ArgumentParser(description="Export GTA mels for vocoder finetune")
    parser.add_argument("-o", "--output-dir", type=Path, default=Path("gta"))
    parser.add_argument("--data-dir", type=Path, default=None)
    parser.add_argument("--ckpt-dir", type=Path, default=None)
    parser.add_argument("--set", action="append", default=[], metavar="K=V")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu to run on the CPU)")
    args = parser.parse_args(argv)
    cfg = apply_overrides(Config(), args.set)
    if args.data_dir:
        cfg = cfg.replace(data_dir=args.data_dir)
    if args.ckpt_dir:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)
    n = generate_gta(args.output_dir, cfg, device=args.device)
    print(f"wrote {n} GTA mel files to {args.output_dir}")


if __name__ == "__main__":
    main()
