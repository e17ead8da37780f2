"""The configuration tree of the PyTorch port (its own copy of
``viettts_tpu/config.py``: the same dataclasses, defaults, phoneme ABI and
``apply_overrides`` parsing, so both packages read the same checkpoints and
token ids; ``tests/test_torch_frontend.py`` holds the two equal).

The hyperparameters mirror the reference vietTTS (``nat/config.py`` and
``assets/hifigan/config.json``) so that datasets, token ids and
checkpoints remain interchangeable, as a frozen dataclass tree with CLI
overrides.  Fields that choose TPU routes (``acoustic.fused_decode``,
``hifigan.fused_inference``) are kept for the shared checkpoint and
config surface; the port's pipeline does not read them.

Token-id ABI: ``special_phonemes + normal_phonemes`` defines the integer id of
every phoneme.  The order below must never change — it is the on-disk contract
for datasets and checkpoints (reference: data_loader.py:11-13).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence, Tuple

# ---------------------------------------------------------------------------
# Phoneme inventory (the ABI).
# ---------------------------------------------------------------------------

SPECIAL_PHONEMES: Tuple[str, ...] = ("sil", "sp", "spn", " ")
SIL_INDEX = SPECIAL_PHONEMES.index("sil")
SP_INDEX = SIL_INDEX  # "sp" is treated as "sil"
WORD_END_INDEX = SPECIAL_PHONEMES.index(" ")

# Vietnamese orthography used as the phoneme set: latin letters plus every
# diacritic combination (89 symbols).  Generated programmatically — the set of
# Vietnamese letters is: the base alphabet (minus f/j/w/z) and all vowels with
# tone marks, in unicode-codepoint order per row of the reference table.
NORMAL_PHONEMES: Tuple[str, ...] = (
    "a", "b", "c", "d", "e", "g", "h", "i", "k", "l",
    "m", "n", "o", "p", "q", "r", "s", "t", "u", "v",
    "x", "y", "à", "á", "â", "ã", "è", "é", "ê", "ì",
    "í", "ò", "ó", "ô", "õ", "ù", "ú", "ý", "ă", "đ",
    "ĩ", "ũ", "ơ", "ư", "ạ", "ả", "ấ", "ầ", "ẩ", "ẫ",
    "ậ", "ắ", "ằ", "ẳ", "ẵ", "ặ", "ẹ", "ẻ", "ẽ", "ế",
    "ề", "ể", "ễ", "ệ", "ỉ", "ị", "ọ", "ỏ", "ố", "ồ",
    "ổ", "ỗ", "ộ", "ớ", "ờ", "ở", "ỡ", "ợ", "ụ", "ủ",
    "ứ", "ừ", "ử", "ữ", "ự", "ỳ", "ỵ", "ỷ", "ỹ",
)

ALL_PHONEMES: Tuple[str, ...] = SPECIAL_PHONEMES + NORMAL_PHONEMES


def phoneme_set() -> Tuple[str, ...]:
    """The full ordered phoneme vocabulary (id = index)."""
    return ALL_PHONEMES


# ---------------------------------------------------------------------------
# Config dataclasses.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DspConfig:
    """STFT / mel-spectrogram front-end parameters.

    Matches the reference DSP (config.py:42-47, assets/hifigan/config.json):
    16 kHz audio, 1024-point FFT, hop 256 (62.5 frames/s), 80 mel bins in
    [0, 8000] Hz with a Slaney-style filterbank.
    """

    sample_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    mel_dim: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_min_clip: float = 1e-5
    mag_eps: float = 1e-9

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length


@dataclass(frozen=True)
class DurationModelConfig:
    """Phoneme-duration regressor (reference model.py:50-70)."""

    vocab_size: int = 256
    lstm_dim: int = 256
    dropout_rate: float = 0.5


@dataclass(frozen=True)
class AcousticModelConfig:
    """Tacotron-2-style acoustic model (reference model.py:73-169)."""

    vocab_size: int = 256
    encoder_dim: int = 256
    encoder_dropout_rate: float = 0.5
    decoder_dim: int = 512
    prenet_dim: int = 256
    prenet_dropout_rate: float = 0.5
    # The reference applies prenet dropout unconditionally — even at
    # inference (model.py:95-100).  Keep that behaviour by default.
    prenet_dropout_at_inference: bool = True
    postnet_dim: int = 512
    postnet_dropout_rate: float = 0.5
    mel_dim: int = 80
    zoneout_rate: float = 0.1
    # Gaussian upsampling temperature: weights = softmax(-(d^2)/sigma2)
    # (reference model.py:107 uses sigma2 = 10.0).
    upsample_sigma2: float = 10.0
    # the JAX package's fused-decode route switch (not read by the port,
    # whose decode is always kernel K1 on CUDA)
    fused_decode: bool = True


@dataclass(frozen=True)
class HifiGanConfig:
    """HiFi-GAN generator/discriminator config (assets/hifigan/config.json)."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    mel_dim: int = 80
    sample_rate: int = 16000
    segment_size: int = 8192
    lrelu_slope: float = 0.1

    # GAN training (reference assets/hifigan/config.json:4-8; training itself
    # is new first-party scope — the reference delegates it to upstream
    # PyTorch hifi-gan).
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    # Steps per LR-decay interval.  0 = one dataset epoch (upstream
    # hifi-gan semantics: scheduler.step() per epoch).  Upstream
    # calibrates the 0.999/epoch decay to LJSpeech-scale epochs
    # (13100 clips / batch 16 ~ 800 steps); on a small corpus the
    # per-epoch default collapses the LR within a few thousand steps
    # (48 clips / batch 16 = 3-step epochs -> lr*0.036 by step 10k),
    # so small-corpus runs should set this explicitly.
    lr_decay_steps: int = 0

    # discriminators (defaults = upstream hifi-gan sizes)
    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    mpd_base_channels: int = 32
    msd_scales: int = 3
    msd_base_channels: int = 128

    # the JAX package's fused-vocoder route switch (not read by the port,
    # whose vocoder always runs kernel K2, or K3 on the int8 route)
    fused_inference: bool = True
    # serving route ("float32" | "bfloat16" | "int8").  bfloat16 stores
    # activations and weights in bf16 and multiplies bf16 operands with
    # float32 sums; int8 runs the MRF convs as int8 x int8 -> int32 dots
    # on top of bf16 storage, with static activation scales calibrated at
    # warmup (Synthesizer.calibrate_int8) or dynamic ones before that.
    # bfloat16 is the default: on trained weights the JAX package measured
    # int8 far from float32 (benchmarks/int8_quality.json), so int8 stays
    # opt-in (--set hifigan.inference_dtype=int8); the CLI's --quality
    # flag forces float32.
    inference_dtype: str = "bfloat16"

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out

    @classmethod
    def from_json(cls, path: str | Path) -> "HifiGanConfig":
        """Load an upstream hifi-gan ``config.json``."""
        with open(path) as f:
            h = json.load(f)
        return cls(
            resblock=str(h.get("resblock", "1")),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]
            ),
            mel_dim=h.get("num_mels", 80),
            sample_rate=h.get("sampling_rate", 16000),
            segment_size=h.get("segment_size", 8192),
            learning_rate=h.get("learning_rate", 2e-4),
            adam_b1=h.get("adam_b1", 0.8),
            adam_b2=h.get("adam_b2", 0.99),
            lr_decay=h.get("lr_decay", 0.999),
        )


@dataclass(frozen=True)
class TrainConfig:
    """Shared trainer hyperparameters (reference config.py:49-55)."""

    batch_size: int = 64
    learning_rate: float = 1e-4
    duration_learning_rate: float = 1e-4
    max_grad_norm: float = 1.0
    weight_decay: float = 1e-4
    token_mask_prob: float = 0.1
    num_training_steps: int = 200_000
    # Number of optimizer steps fused into one dispatch (the reference's
    # acoustic trainer uses 10).
    steps_per_update: int = 1
    seed: int = 42
    val_interval: int = 10
    ckpt_interval: int = 1000
    # Data-parallel ranks; -1 = the process group's world size (one device
    # without a group).  Any other value must equal the world size: launch
    # one process per device under torchrun (parallel/mesh.py).
    num_devices: int = -1
    # ZeRO/FSDP-style sharding of the large leaves' parameters and Adam
    # moments across the ranks, at rest (train/common.py::FsdpClipAdamW).
    # Needs a process group.
    fsdp: bool = False
    # Opt-in bf16 mixed precision: f32 master params, forward/backward
    # compute in bfloat16 (params cast at the loss boundary).
    mixed_precision: bool = False
    # Training-checkpoint backend: "pickle" (single atomic file, the
    # reference's contract) or "orbax" (sharded tensorstore directory, for
    # multi-host runs where one pickle is impractical; the port's trainers
    # refuse it: Orbax is a JAX library).
    checkpoint_format: str = "pickle"

    def __post_init__(self):
        if self.num_devices == 0 or self.num_devices < -1:
            raise ValueError(f"train.num_devices={self.num_devices}: -1 (the world size) or a device count")


@dataclass(frozen=True)
class DataConfig:
    """Dataset limits (reference config.py:19-22)."""

    max_phoneme_seq_len: int = 256
    max_wave_len: int = 1024 * 64 * 3  # 196608 samples = ~12.3 s @ 16 kHz
    train_split: float = 0.95
    shuffle_seed: int = 42


@dataclass(frozen=True)
class Config:
    """Top-level framework config."""

    dsp: DspConfig = field(default_factory=DspConfig)
    duration: DurationModelConfig = field(default_factory=DurationModelConfig)
    acoustic: AcousticModelConfig = field(default_factory=AcousticModelConfig)
    hifigan: HifiGanConfig = field(default_factory=HifiGanConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    ckpt_dir: Path = Path("assets/infore/nat")
    hifigan_ckpt_dir: Path = Path("assets/infore/hifigan")
    data_dir: Path = Path("train_data")

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)


DEFAULT_CONFIG = Config()


# ---------------------------------------------------------------------------
# CLI override helpers: ``--train.batch_size=32 --dsp.n_fft=1024`` style.
# ---------------------------------------------------------------------------


def _coerce(value: str, old: Any) -> Any:
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, Path):
        return Path(value)
    if isinstance(old, tuple):
        parts = [p for p in value.strip("()[] ").split(",") if p]
        elem = old[0] if old else 0
        return tuple(_coerce(p.strip(), elem) for p in parts)
    return value


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``section.key=value`` overrides to a Config tree."""
    for item in overrides:
        item = item.lstrip("-")
        if "=" not in item:
            raise ValueError(f"Override must look like key=value, got: {item}")
        key, value = item.split("=", 1)
        parts = key.split(".")
        if len(parts) == 1:
            old = getattr(cfg, parts[0])
            cfg = dataclasses.replace(cfg, **{parts[0]: _coerce(value, old)})
        elif len(parts) == 2:
            section = getattr(cfg, parts[0])
            old = getattr(section, parts[1])
            new_section = dataclasses.replace(
                section, **{parts[1]: _coerce(value, old)}
            )
            cfg = dataclasses.replace(cfg, **{parts[0]: new_section})
        else:
            raise ValueError(f"Too many levels in override key: {key}")
    return cfg
