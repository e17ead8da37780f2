#!/usr/bin/env python3
"""Where a training step spends its time on the card: ``torch.profiler``
over one optimizer step of the port's duration trainer (B=64, 256 tokens),
of its acoustic trainer (B=64, 768 frames) and of its HiFi-GAN trainer
(B=64, segment 8192, MPD + MSD), at the full default width, after two
warm-up steps, on ``chip_smoke.py``'s synthetic corpus, with PyTorch's
TF32 defaults (cuDNN convs TF32, matmuls float32).

    python3 scripts/profile_torch_training.py [--out DIR]

Prints per trainer: wall time with the profiler on, summed device time,
the device-busy share, host-issued launches (device-side entries), and the
ten largest device-time entries; then one JSON line.  With ``--out`` it
also writes one Chrome trace per trainer.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import build_corpus  # noqa: E402
from profile_torch_synthesis import profile_once  # noqa: E402


def one_step(kind, cfg, device):
    """(update, state, batch) of ``kind``'s trainer at ``cfg``, warmed up
    by two steps."""
    import torch

    from viettts_tpu_torch.data.loader import AcousticDataset, DurationDataset, to_device
    from viettts_tpu_torch.models.acoustic import AcousticModel
    from viettts_tpu_torch.models.duration import DurationModel
    from viettts_tpu_torch.models.layers import batch_stats
    from viettts_tpu_torch.ops.mel import LogMelSpectrogram
    from viettts_tpu_torch.train import acoustic, duration
    from viettts_tpu_torch.train.common import init_train_state, make_optimizer, make_update_fn

    tcfg, seq = cfg.train, cfg.data.max_phoneme_seq_len
    if kind == "duration":
        model = DurationModel(cfg.duration)
        ds = DurationDataset(cfg.data_dir, seq, "train", cfg.data)
    else:
        model = AcousticModel(cfg.acoustic)
        ds = AcousticDataset(cfg.data_dir, seq, cfg.data.max_wave_len, "train", cfg.data, cfg.dsp.sample_rate)
    model.init_params(torch.Generator().manual_seed(tcfg.seed))
    model.to(device)
    if kind == "duration":
        loss_fn = duration.make_loss_fn(model, tcfg.token_mask_prob, train=True)
    else:
        mel_fn = LogMelSpectrogram(cfg.dsp).to(device)
        loss_fn = acoustic.make_loss_fn(model, mel_fn, cfg.dsp.hop_length, train=True)
    opt = make_optimizer(tcfg.learning_rate, tcfg.max_grad_norm, tcfg.weight_decay)
    update = make_update_fn(loss_fn, opt)
    state = init_train_state(dict(model.named_parameters()), batch_stats(model), opt,
                             torch.Generator(device).manual_seed(tcfg.seed))
    batch = to_device(next(ds.batches(tcfg.batch_size, seed=tcfg.seed)), device)
    for _ in range(2):
        state, loss = update(state, [batch])
        float(loss)
    return update, state, batch


def gan_step(cfg, device):
    """(step, state, batch) of the GAN trainer at ``cfg``, audio-only,
    warmed up by two steps."""
    from viettts_tpu_torch.data.loader import to_device
    from viettts_tpu_torch.train.hifigan import VocoderDataset, build_gan

    state, step = build_gan(cfg, device, cfg.hifigan.learning_rate)
    ds = VocoderDataset(cfg.data_dir, cfg.hifigan.segment_size, cfg.dsp.hop_length)
    batch = to_device(next(ds.batches(cfg.train.batch_size, seed=cfg.train.seed)), device)
    for _ in range(2):
        state, metrics = step(state, *batch)
        float(metrics["gen_loss"])
    return step, state, batch


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=None, help="directory for Chrome traces")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 1
    from viettts_tpu_torch.config import Config

    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    device = torch.device("cuda")
    results = {}
    with tempfile.TemporaryDirectory(prefix="profile_training_") as tmp:
        build_corpus(Path(tmp))
        cfg = Config().replace(data_dir=Path(tmp))
        for kind in ("duration", "acoustic"):
            update, state, batch = one_step(kind, cfg, device)
            trace = None if args.out is None else args.out / f"trace_train_{kind}.json"
            res = profile_once(lambda: float(update(state, [batch])[1]), trace)
            results[kind] = res
            print(f"train {kind}: wall {res['wall_ms']:.1f} ms (profiler on), device {res['device_ms']:.1f} ms "
                  f"({100 * res['busy_share']:.0f}% busy), {res['device_entries']} device entries", flush=True)
            for row in res["top"]:
                print(f"    {row['ms']:8.3f} ms  {row['calls']:6d}x  {row['name']}")
        step, state, batch = gan_step(cfg, device)
        trace = None if args.out is None else args.out / "trace_train_hifigan.json"
        res = profile_once(lambda: float(step(state, *batch)[1]["gen_loss"]), trace)
        results["hifigan"] = res
        print(f"train hifigan: wall {res['wall_ms']:.1f} ms (profiler on), device {res['device_ms']:.1f} ms "
              f"({100 * res['busy_share']:.0f}% busy), {res['device_entries']} device entries", flush=True)
        for row in res["top"]:
            print(f"    {row['ms']:8.3f} ms  {row['calls']:6d}x  {row['name']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "profile": {k: {kk: vv for kk, vv in v.items() if kk not in ("top", "groups_ms")}
                                               for k, v in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
