"""HiFi-GAN vocoder trainer, from scratch or GTA finetuning (counterpart of
``viettts_tpu/train/hifigan.py``).

    python -m viettts_tpu_torch.train.hifigan --wav-dir WAVS [--gta-dir GTA] --ckpt-dir OUT \\
        [--steps N] [--disc-init DISC.pickle] [--set K=V ...] [--device cpu]

The JAX trainer's recipe: random ``segment_size`` crops (on hop
boundaries), a discriminator step (LSGAN, MPD + MSD) and then a
generator step against the updated discriminators (LSGAN + 2x feature
matching + 45x the float32 L1 of the log-mels), both with optax's
``adamw(b1=0.8, b2=0.99)`` (weight decay 1e-4, no clipping) under the
upstream per-epoch ``0.999`` staircase decay.  The generator trains with
explicit weight norm; its checkpoint holds the folded inference params
beside the raw resumable state, in the JAX package's native pickle, so
either package resumes the other's run and serves its vocoder.

Under ``train.mixed_precision`` the generator computes in bfloat16 (its
weight-norm fold in float32) and the discriminators' parameters and
spectral ``u`` are cast to bfloat16 before their fold, as JAX casts them;
master parameters, optimizer state, losses and the mel L1 stay float32.
The generator runs forward once a step: the discriminator step takes its
output detached, and the generator step differentiates the same graph
(JAX runs it twice; it is the same function of the same parameters).
It runs on the card unless given ``--device cpu``.

Data-parallel, one process per card: every rank draws the global batch of
crops and keeps its rows; the discriminator and the generator gradients
are each averaged over the ranks before their optimizer (the losses are
means over equal rows); the spectral ``u`` depends on the weights only,
so it stays equal on every rank; rank 0 prints and writes checkpoints::

    torchrun --nproc-per-node N -m viettts_tpu_torch.train.hifigan ... --set train.num_devices=N
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from viettts_tpu_torch.audio import read_wav
from viettts_tpu_torch.checkpoint import NATIVE_FORMAT, fold_weight_norm, gan_tree, named_from_gan_tree
from viettts_tpu_torch.config import Config
from viettts_tpu_torch.data.loader import prefetch_to_device
from viettts_tpu_torch.models.discriminators import (
    Discriminators,
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    init_gan_params,
)
from viettts_tpu_torch.models.hifigan import Generator
from viettts_tpu_torch.ops.mel import LogMelSpectrogram
from viettts_tpu_torch.parallel import mesh
from viettts_tpu_torch.train.checkpoint import check_format, jax_key, load_checkpoint, save_checkpoint
from viettts_tpu_torch.train.common import (
    AdamWState,
    ClipAdamW,
    MetricAverager,
    Tensors,
    exponential_decay,
    launch_device,
    opt_state_from_optax,
    opt_state_to_optax,
    resolve_device,
)
from viettts_tpu_torch.utils.profiling import StepTimer, annotate, trace

MEL_LOSS_WEIGHT = 45.0
FM_LOSS_WEIGHT = 1.0  # feature_matching_loss already multiplies by 2
METRICS = ("disc_loss", "gen_loss", "mel_l1", "adv", "fm")


class GanState(NamedTuple):
    step: int
    gen_params: Tensors  # the weight-normalized generator's, by name (its own tensors)
    disc_params: Tensors  # the discriminators' (``mpd.*``, ``msd.*``)
    spectral: Tensors  # the MSD's power-iteration vectors (``disc_s0.conv_0.u``, ...)
    gen_opt: AdamWState
    disc_opt: AdamWState
    rng: np.ndarray  # uint32[2], JAX's key of the seed (the step draws nothing)


class VocoderBatch(NamedTuple):
    mels: Optional[np.ndarray]  # [B, frames, mel_dim] GTA mels, or None
    audio: np.ndarray  # [B, segment_size] float32 in [-1, 1)


class VocoderDataset:
    """Waveforms (and GTA mels in finetuning) in RAM; random segment
    batches drawn from the JAX trainer's ``np.random.RandomState`` stream,
    so a seed gives the same crops."""

    def __init__(self, wav_dir: Path, segment_size: int, hop: int, gta_dir: Optional[Path] = None,
                 sample_rate: int = 16000):
        self.segment_size = segment_size
        self.hop = hop
        self.frames = segment_size // hop
        self.wavs: List[np.ndarray] = []
        self.mels: List[np.ndarray] = []  # only in finetuning mode
        self.gta = gta_dir is not None
        for wav_file in sorted(Path(wav_dir).glob("*.wav")):
            sr, y = read_wav(wav_file)
            if y.ndim > 1:
                y = y[:, 0]
            y = y.astype(np.float32) / (2.0**15)
            if len(y) < segment_size + hop:
                y = np.pad(y, (0, segment_size + hop - len(y)))
            if self.gta:
                mel_file = Path(gta_dir) / f"{wav_file.stem}.npy"
                if not mel_file.exists():
                    continue
                mel = np.load(mel_file).T.astype(np.float32)  # [T, D]
                if mel.shape[0] < self.frames + 1:
                    continue
                self.mels.append(mel)
            self.wavs.append(y)
        if not self.wavs:
            raise ValueError(f"no usable audio in {wav_dir}")

    def __len__(self) -> int:
        return len(self.wavs)

    def batches(self, batch_size: int, seed: int = 0) -> Iterator[VocoderBatch]:
        rng = np.random.RandomState(seed)
        n = len(self.wavs)
        while True:
            idx = rng.randint(0, n, size=batch_size)
            audio = np.zeros((batch_size, self.segment_size), np.float32)
            mels = np.zeros((batch_size, self.frames, self.mels[0].shape[1]), np.float32) if self.gta else None
            for j, i in enumerate(idx):
                y = self.wavs[i]
                if self.gta:
                    mel = self.mels[i]
                    max_f = min(len(y) // self.hop, mel.shape[0]) - self.frames
                    f0 = rng.randint(0, max(max_f, 1))
                    mels[j] = mel[f0 : f0 + self.frames]
                    audio[j] = y[f0 * self.hop : f0 * self.hop + self.segment_size]
                else:
                    s0 = rng.randint(0, len(y) - self.segment_size + 1)
                    s0 = (s0 // self.hop) * self.hop  # mel(audio) frames on the conditioning frames
                    audio[j] = y[s0 : s0 + self.segment_size]
            yield VocoderBatch(mels, audio)


def _cast(tree: Tensors, dtype: torch.dtype) -> Tensors:
    return {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in tree.items()}


def make_gan_step(cfg: Config, generator: Generator, discs: Discriminators, gen_tx: ClipAdamW,
                  disc_tx: ClipAdamW, mel_fn: LogMelSpectrogram, data_parallel: bool = False):
    """``step(state, mel_in, audio) -> (state, metrics)``: one
    discriminator step, then one generator step; parameters and moments
    are updated in place, the spectral state is replaced.  ``mel_in`` is
    the GTA mel [B, frames, mel_dim] or None (the mels of ``audio``);
    ``audio`` [B, segment_size].  With ``data_parallel`` they are this
    rank's rows of the global batch: both gradients and the metrics are
    averaged over the ranks."""
    mixed = cfg.train.mixed_precision

    def reduce(grads):
        return mesh.all_reduce_grads(grads, "mean") if data_parallel else grads

    def cast(tree):
        return _cast(tree, torch.bfloat16) if mixed else tree

    def cast_t(x):
        return x.to(torch.bfloat16) if mixed else x

    def step(state: GanState, mel_in: Optional[torch.Tensor], audio: torch.Tensor):
        y = audio[:, None, :]  # [B, 1, S]
        mel_target = mel_fn(audio)
        cond = mel_in if mel_in is not None else mel_target
        y_hat = functional_call(generator, state.gen_params, (cond,)).transpose(1, 2)  # [B, 1, S] f32

        # discriminator step (generator frozen)
        mpd, msd, spectral = functional_call(
            discs, cast(state.disc_params),
            (cast_t(y), cast_t(y_hat.detach()), cast(state.spectral), True),
        )
        d_loss = discriminator_loss(mpd[0], mpd[1]) + discriminator_loss(msd[0], msd[1])
        spectral = {k: v.float() for k, v in spectral.items()}
        names = list(state.disc_params)
        grads = reduce(torch.autograd.grad(d_loss, [state.disc_params[k] for k in names]))
        disc_opt = disc_tx.update(dict(zip(names, grads)), state.disc_opt, state.disc_params)

        # generator step (the updated discriminators, frozen)
        mel_l1 = torch.mean(torch.abs(mel_fn(y_hat[:, 0].float()) - mel_target))
        frozen = cast({k: v.detach() for k, v in state.disc_params.items()})
        mpd, msd, _ = functional_call(discs, frozen, (cast_t(y), cast_t(y_hat), cast(spectral), False))
        adv = generator_adversarial_loss(mpd[1]) + generator_adversarial_loss(msd[1])
        fm = feature_matching_loss(mpd[2], mpd[3]) + feature_matching_loss(msd[2], msd[3])
        g_loss = adv + FM_LOSS_WEIGHT * fm + MEL_LOSS_WEIGHT * mel_l1
        names = list(state.gen_params)
        grads = reduce(torch.autograd.grad(g_loss, [state.gen_params[k] for k in names]))
        gen_opt = gen_tx.update(dict(zip(names, grads)), state.gen_opt, state.gen_params)

        values = torch.stack([v.detach().float() for v in (d_loss, g_loss, mel_l1, adv, fm)])
        if data_parallel:
            values = mesh.all_reduce_value(values, "mean")
        metrics = dict(zip(METRICS, values.unbind()))
        return state._replace(step=state.step + 1, spectral=spectral, gen_opt=gen_opt, disc_opt=disc_opt), metrics

    return step


# ---------------------------------------------------------------------------
# Checkpoints (the JAX package's native pickle).
# ---------------------------------------------------------------------------


def _raw(state: GanState, resblock2: bool) -> Dict:
    """The resumable state as the JAX package's trees (numpy)."""

    def gen(named):
        return gan_tree(named, resblock2)

    return {
        "gen_params": gen(state.gen_params),
        "disc_params": gan_tree(state.disc_params),
        "spectral": gan_tree(state.spectral),
        "gen_opt": opt_state_to_optax(state.gen_opt, clipped=False, to_tree=gen),
        "disc_opt": opt_state_to_optax(state.disc_opt, clipped=False, to_tree=gan_tree),
        "rng": np.asarray(state.rng, np.uint32),
    }


def save_vocoder_ckpt(path: Path, state: GanState, resblock2: bool = False) -> None:
    """One atomic pickle: the folded inference params (what
    ``load_variables(..., "hifigan")`` serves) and the raw resumable
    state.  Tensors may be on any device; a CPU copy is cheapest to
    write from another thread."""
    raw = _raw(state, resblock2)
    save_checkpoint(path, {
        "format": NATIVE_FORMAT,
        "step": int(state.step),
        "variables": {"params": fold_weight_norm(raw["gen_params"])},
        "raw": raw,
    })


def _copy_into(dst: Tensors, arrays: Dict[str, np.ndarray]) -> None:
    with torch.no_grad():
        for name, a in arrays.items():
            src = torch.from_numpy(a)
            if tuple(src.shape) != tuple(dst[name].shape):
                raise ValueError(f"{name}: checkpoint {tuple(src.shape)}, model {tuple(dst[name].shape)}")
            dst[name].copy_(src)


def _spectral_from(tree, template: Tensors) -> Tensors:
    return {k: torch.from_numpy(a).to(template[k].device)
            for k, a in named_from_gan_tree(tree, list(template)).items()}


def restore_vocoder_state(path: Path, template: GanState, resblock2: bool = False) -> Optional[GanState]:
    """Resume from a native vocoder checkpoint written by either package:
    parameters are copied into ``template``'s tensors (the modules' own),
    moments and spectral state onto their devices.  None when ``path``
    holds no resumable state."""
    dic = load_checkpoint(path)
    if dic is None or "raw" not in dic:
        return None
    raw = dic["raw"]

    def gen(tree, names):
        return named_from_gan_tree(tree, names, resblock2)

    _copy_into(template.gen_params, gen(raw["gen_params"], list(template.gen_params)))
    _copy_into(template.disc_params, named_from_gan_tree(raw["disc_params"], list(template.disc_params)))
    rng = raw.get("rng")
    return template._replace(
        step=int(dic["step"]),
        spectral=_spectral_from(raw.get("spectral", {}), template.spectral),
        gen_opt=opt_state_from_optax(raw["gen_opt"], template.gen_params, gen),
        disc_opt=opt_state_from_optax(raw["disc_opt"], template.disc_params, named_from_gan_tree),
        rng=template.rng if rng is None else np.asarray(rng, np.uint32),
    )


def _structure(tree):
    """A tree's nesting of keys, leaves as None."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    return None


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _leaves(v, f"{prefix}['{k}']")
    else:
        yield prefix, np.asarray(tree)


def _load_disc_init(path: Path, template: GanState) -> GanState:
    """Warm-start the discriminators and the spectral ``u`` from a
    converted upstream ``do_*`` checkpoint (``tools.convert_torch_hifigan
    --do-file``); the optimizer moments start fresh.  The trees are held
    to the configured discriminators' so that a mismatch fails loudly."""
    dic = load_checkpoint(path)
    if dic is None or "disc_params" not in dic:
        raise ValueError(f"{path} is not a discriminator-init checkpoint")
    disc_params, spectral = dic["disc_params"], dic.get("spectral", {})
    for name, got, want in (("disc_params", disc_params, gan_tree(template.disc_params)),
                            ("spectral", spectral, gan_tree(template.spectral))):
        got_s, want_s = _structure(got), _structure(want)
        if got_s != want_s:
            raise ValueError(
                f"--disc-init {name} tree does not match the configured discriminators: {got_s} vs {want_s}"
            )
        mismatched = [f"{k}: {g.shape} vs {w.shape}"
                      for (k, g), (_, w) in zip(_leaves(got), _leaves(want)) if g.shape != w.shape]
        if mismatched:
            raise ValueError(f"--disc-init {name} shapes mismatch: {mismatched[:5]}")
    print(f"Warm-starting discriminators from {path}")
    _copy_into(template.disc_params, named_from_gan_tree(disc_params, list(template.disc_params)))
    return template._replace(spectral=_spectral_from(spectral, template.spectral))


# ---------------------------------------------------------------------------
# The trainer.
# ---------------------------------------------------------------------------


def _host_copy(state: GanState) -> GanState:
    """The state with every tensor copied to the host (a snapshot the
    next step cannot change)."""

    def cpu(tree):
        return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}

    def opt(s: AdamWState):
        return s._replace(mu=cpu(s.mu), nu=cpu(s.nu))

    return state._replace(gen_params=cpu(state.gen_params), disc_params=cpu(state.disc_params),
                          spectral=cpu(state.spectral), gen_opt=opt(state.gen_opt), disc_opt=opt(state.disc_opt))


def build_gan(cfg: Config, device, learning_rate, data_parallel: bool = False) -> Tuple[GanState, Callable]:
    """The weight-normalized generator and the discriminators at ``cfg``'s
    width, cold-initialised from ``cfg.train.seed`` and moved to
    ``device``; their state with fresh optimizers (``adamw`` at
    ``learning_rate``, a float or a schedule) and the step function
    (``make_gan_step``'s ``data_parallel``)."""
    hcfg, tcfg = cfg.hifigan, cfg.train
    generator = Generator(hcfg, use_wn=True, dtype=torch.bfloat16 if tcfg.mixed_precision else torch.float32)
    discs = Discriminators(hcfg.mpd_periods, hcfg.mpd_base_channels, hcfg.msd_scales, hcfg.msd_base_channels)
    init = torch.Generator().manual_seed(tcfg.seed)
    init_gan_params(generator, init)
    init_gan_params(discs, init)
    spectral = {k: v.to(device) for k, v in discs.init_spectral(init).items()}
    generator.to(device)
    discs.to(device)
    gen_tx, disc_tx = (ClipAdamW(learning_rate, None, tcfg.weight_decay, hcfg.adam_b1, hcfg.adam_b2)
                       for _ in range(2))
    gen_params, disc_params = dict(generator.named_parameters()), dict(discs.named_parameters())
    state = GanState(0, gen_params, disc_params, spectral, gen_tx.init(gen_params), disc_tx.init(disc_params),
                     jax_key(init))
    return state, make_gan_step(cfg, generator, discs, gen_tx, disc_tx, LogMelSpectrogram(cfg.dsp).to(device),
                                data_parallel)


def train(
    cfg: Config = Config(),
    wav_dir: Optional[Path] = None,
    gta_dir: Optional[Path] = None,
    num_steps: Optional[int] = None,
    log_every: int = 1000,
    on_metrics=None,
    disc_init: Optional[Path] = None,
    device="cuda",
    step_log: Optional[List] = None,
    on_state=None,
    on_state_every: int = 0,
) -> GanState:
    """Train to ``num_steps`` (default ``cfg.train.num_training_steps``),
    resuming from ``ckpt_dir/hifigan_latest_ckpt.pickle`` when it holds a
    resumable state (the checkpoint format is ``cfg.train``'s: pickle
    only).  ``on_metrics(step, metrics)`` sees each step's metrics
    (tensors); with a ``step_log`` list each step waits for the device and
    appends (its seconds, its metrics as floats).  ``on_state(step,
    state)`` is called every ``on_state_every`` steps (a probe of the live
    weights)."""
    hcfg, tcfg = cfg.hifigan, cfg.train
    check_format(tcfg.checkpoint_format)
    device = resolve_device(device)
    if tcfg.fsdp:
        raise ValueError("train.fsdp: the GAN trainer replicates its state, as the JAX trainer does")
    dp = mesh.check_data_parallel(tcfg.num_devices, tcfg.batch_size)
    main_rank = mesh.world()[0] == 0
    resblock2 = hcfg.resblock == "2"
    ds = VocoderDataset(wav_dir or cfg.data_dir, hcfg.segment_size, cfg.dsp.hop_length, gta_dir=gta_dir,
                        sample_rate=cfg.dsp.sample_rate)
    # upstream hifi-gan decays the LR once per epoch (one pass over the
    # dataset); hcfg.lr_decay_steps overrides the interval on small corpora
    steps_per_epoch = hcfg.lr_decay_steps or max(1, len(ds) // tcfg.batch_size)
    state, step_fn = build_gan(
        cfg, device, exponential_decay(hcfg.learning_rate, steps_per_epoch, hcfg.lr_decay, staircase=True), dp
    )

    ckpt_path = Path(cfg.ckpt_dir) / "hifigan_latest_ckpt.pickle"
    restored = restore_vocoder_state(ckpt_path, state, resblock2)
    if restored is not None:
        if main_rank:
            print(f"Resuming vocoder from {ckpt_path} at step {restored.step}")
        state = restored
    elif disc_init is not None:
        # a fresh run (typically GTA finetuning); a run's own resume state
        # takes precedence above
        state = _load_disc_init(disc_init, state)
    # the crop stream continues past what the run consumed, as in JAX; each
    # rank keeps its rows of the global batch
    batches = ds.batches(tcfg.batch_size, seed=tcfg.seed + state.step)
    data = prefetch_to_device(map(mesh.shard_batch, batches) if dp else batches, device)
    num_steps = num_steps or tcfg.num_training_steps

    # in-loop checkpoints: a host copy of the state, then one background
    # writer; the next save waits for the one in flight
    writer: List[Optional[threading.Thread]] = [None]

    def save_async(st: GanState) -> None:
        if not main_rank:
            return
        if writer[0] is not None:
            writer[0].join()
        t = threading.Thread(target=save_vocoder_ckpt, args=(ckpt_path, _host_copy(st), resblock2), daemon=True)
        t.start()
        writer[0] = t

    avg = {k: MetricAverager(log_every) for k in ("disc_loss", "gen_loss", "mel_l1")}
    timer = StepTimer(device)
    step = state.step
    with trace():  # a device trace when VIETTTS_PROFILE_DIR is set
        while step < num_steps:
            mel_in, audio = next(data)
            tick = time.perf_counter()
            with annotate("gan_step"):
                state, metrics = step_fn(state, mel_in, audio)
            if step_log is not None:
                values = {k: float(v) for k, v in metrics.items()}  # waits for the device
                step_log.append((time.perf_counter() - tick, values))
            step += 1
            timer.tick()
            for k in avg:
                avg[k].add(metrics[k])
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % log_every == 0 and main_rank:
                print(f"step {step:>7d} | disc {avg['disc_loss'].mean():.3f} | gen {avg['gen_loss'].mean():.3f}"
                      f" | mel_l1 {avg['mel_l1'].mean():.4f} | {timer.steps_per_sec():.2f} steps/s")
            if on_state is not None and on_state_every and step % on_state_every == 0:
                on_state(step, state)
            if step % tcfg.ckpt_interval == 0:
                save_async(state)
    if writer[0] is not None:
        writer[0].join()
    if main_rank:
        save_vocoder_ckpt(ckpt_path, state, resblock2)
    return state


def main(argv=None):
    from argparse import ArgumentParser

    from viettts_tpu_torch.config import apply_overrides

    parser = ArgumentParser(description="Train the HiFi-GAN vocoder")
    parser.add_argument("--wav-dir", type=Path, default=None)
    parser.add_argument("--gta-dir", type=Path, default=None, help="GTA mel dir (tools.gta output) for finetuning")
    parser.add_argument("--ckpt-dir", type=Path, default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument(
        "--disc-init", type=Path, default=None,
        help="converted upstream do_* discriminator checkpoint (tools.convert_torch_hifigan --do-file) "
             "to warm-start MPD/MSD for GTA finetuning",
    )
    parser.add_argument("--set", action="append", default=[], metavar="K=V")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu to train on the CPU)")
    args = parser.parse_args(argv)
    cfg = apply_overrides(Config(), args.set)
    if args.ckpt_dir:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)
    Path(cfg.ckpt_dir).mkdir(parents=True, exist_ok=True)
    train(cfg, wav_dir=args.wav_dir, gta_dir=args.gta_dir, num_steps=args.steps, disc_init=args.disc_init,
          device=launch_device(args.device))


if __name__ == "__main__":
    main()
