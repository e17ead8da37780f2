"""End-to-end synthesis: text -> tokens -> durations -> mel -> wave
(counterpart of ``viettts_tpu/infer/pipeline.py``).

Kept from the JAX pipeline, because outputs depend on them:

* token and frame bucketing (``DEFAULT_TOKEN_BUCKETS``, ``FRAME_BUCKET``):
  the k=3 encoder conv at the last real token sees the padding token, and
  the vocoder's SAME convs see the padded frames, so parity with the JAX
  Synthesizer needs the same padding;
* duration postprocessing (silence clamp, zeroed word-end markers and
  padding) and the trailing-silence trim;
* long-form chunking at silence / word boundaries;
* prenet dropout drawn afresh for every dispatch from ``prenet_seed``, so
  the same text gives the same audio.

Vocoder routes (``hifigan.inference_dtype``): ``float32``, ``bfloat16``
storage, and ``int8``, which is bfloat16 storage with the MRF convs in
int8 (kernel K3).  ``warmup`` calibrates the int8 route's static
activation scales first (``calibrate_int8``); ``int8_clip_stats`` is the
sampled probe of what those scales clip.  ``stream`` yields audio chunk by
chunk: chunk 0 as soon as it is computed, then each chunk with the next
one's device work already queued.

``Synthesizer(devices=[...])`` is the counterpart of JAX's ``mesh=``: one
acoustic model and one generator per device, the duration model on the
first.  ``synthesize_batch`` pads the batch to a multiple of the device
count with silent one-token rows, gives every device its shard with one
frame budget for all (JAX decodes the whole batch in one program),
dispatches every shard before finalizing any, so the devices overlap,
and drops the pad rows; each shard's prenet dropout is seeded from
``prenet_seed`` and the shard index, as JAX folds the index into its key.
``synthesize`` and ``stream`` run on the first device.

The single-dispatch lead program (JAX's ``_lead_fn``): a row of at most
``single_dispatch_max_tokens`` (64) tokens goes through durations, their
postprocessing, the decode of a static ``LEAD_FRAMES_PER_TOKEN`` (8)
frames a token and the vocoder with no host read in between, then one set
of copies to the host; a predicted frame total beyond that budget falls
back to the bucketed path.  ``synthesize``, a one-text
``synthesize_batch`` and ``stream``'s chunk 0 take it, as in JAX; the
decode of the static budget instead of the duration-derived bucket pads
the vocoder differently, so it is also what makes their audio JAX's.  On
CUDA each token bucket's program is one ``torch.cuda.CUDAGraph``, captured
after one eager run at ``warmup`` or at the bucket's first use (all
captures share one memory pool) and replayed under a lock; on the CPU it
runs eagerly, and only where JAX's CPU backend takes it (with
``acoustic.fused_decode`` and ``hifigan.fused_inference`` both off).
``single_dispatch_max_tokens = 0`` turns it off everywhere (JAX's
``stream`` leads with it whenever ``lead_tokens`` is set, whatever that
attribute says).

Frame-bucket snapping (JAX's ``_dispatch_decode``): a bucketed dispatch
of padded shape (B, T) decodes its natural frame bucket unless a larger
bucket of that shape, at most twice the natural one, has already run
(``warmup`` or earlier traffic); then it decodes the smallest such
bucket.  JAX snaps to reuse a compiled program; the port has nothing to
compile, and snaps because the padding the vocoder sees is part of the
result: its SAME convs near a row's last kept frame read decoded frames in
the larger bucket and zero padding in the smaller, so the tail of the
audio differs (up to 0.56 max abs on a tiny model).  ``warmup`` runs
JAX's buckets (4 and 8 frames a token of each token bucket, and the 2x
steps above 8 for each of ``silence_durations``).  The buckets are kept
per padded global (B, T), as JAX keys them under a mesh; ``stream``'s
chunks key by (device count, T), as JAX replicates a chunk over the mesh.

Not ported: the scan-decode batch gate (the port has no scan decode: K1
runs every batch, in launches of up to 64 rows, and plans every decoder
width: where its float32 gate columns outgrow the card's shared memory,
as Tacotron 2's 1024 do, part of them streams every frame; JAX's
``pick_chunk`` gate sends such widths to its scan).  The decode always takes
``ops.ar_decoder.ar_decode`` and the vocoder always
``models.hifigan.generator_apply_fused`` (the kernels on CUDA, their
plain twins on CPU); ``acoustic.fused_decode`` and
``hifigan.fused_inference`` choose TPU routes, and are read only by the
CPU gate of the lead program: the int8 route is the fused one, as it is
in JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from viettts_tpu_torch.checkpoint import (
    load_acoustic,
    load_duration,
    load_generator,
    load_variables,
)
from viettts_tpu_torch.config import SIL_INDEX, WORD_END_INDEX, Config
from viettts_tpu_torch.models.acoustic import AcousticModel
from viettts_tpu_torch.models.duration import DurationModel
from viettts_tpu_torch.models.hifigan import (
    Generator,
    generator_apply_fused,
    generator_calibrate_int8,
    generator_int8_clip_stats,
)
from viettts_tpu_torch.ops.ar_decoder import ar_decode
from viettts_tpu_torch.ops.mrf import fused_mrf
from viettts_tpu_torch.text import load_lexicon, normalize_text, text_to_tokens
from viettts_tpu_torch.types import DurationBatch

DEFAULT_TOKEN_BUCKETS = (32, 64, 128, 192, 256, 384, 512)
FRAME_BUCKET = 128  # frames are padded to a multiple of this
# static frame budget of the lead program: covers the ~4-8 frames a token
# of real Vietnamese speech; a larger predicted total falls back to the
# bucketed path
LEAD_FRAMES_PER_TOKEN = 8
# the kernels' launch counters and their twins' call counters: a captured
# graph records what its capture counted and each replay adds it
_COUNTERS = ((ar_decode, "launches"), (ar_decode, "plain_calls"), (fused_mrf, "launches"),
             (fused_mrf, "int8_launches"), (fused_mrf, "plain_calls"), (fused_mrf, "conv_launches"),
             (fused_mrf, "int8_conv_launches"), (fused_mrf, "tf32_conv_launches"),
             (fused_mrf, "int8_dynamic_conv_launches"))


def _bucket_tokens(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


def _bucket_frames(n: int, bucket: int = FRAME_BUCKET) -> int:
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def _warmup_frame_buckets(tb: int, silence_durations: Sequence[float], fps: float) -> List[int]:
    """The frame buckets ``warmup`` runs for token bucket ``tb`` (JAX's
    coverage): those of 4 and 8 frames a token, and for each silence clamp
    of ``s`` seconds (which can pace a row of ``sil`` at ``s * fps`` frames
    a token) the 2x steps above 8 frames a token up to that pace."""
    cover = {_bucket_frames(tb * 4), _bucket_frames(tb * 8)}
    for s in silence_durations:
        ceil_f = tb * max(8.0, float(s) * fps)
        f = tb * 8
        while f < ceil_f:
            f = min(f * 2, ceil_f)
            cover.add(_bucket_frames(int(f)))
    return sorted(cover)


def _cut_once(rest: List[int], limit: int) -> Tuple[List[int], List[int]]:
    """Cut one chunk of at most ``limit`` tokens off the front of ``rest``,
    preferring silence boundaries, then word-end boundaries.  Returns
    (chunk, remainder); the remainder is empty when everything fit."""
    if len(rest) <= limit:
        return rest, []
    for i in range(limit - 1, 0, -1):
        if rest[i] == SIL_INDEX:
            return rest[: i + 1], rest[i:]  # shared sil leads the remainder
    cut = None
    for i in range(limit - 2, 0, -1):
        if rest[i] == WORD_END_INDEX:
            cut = i
            break
    if cut is None:  # no boundary at all: hard cut
        cut = limit - 2
    return rest[: cut + 1] + [SIL_INDEX], [SIL_INDEX] + rest[cut + 1 :]


def _chunk_token_rows(
    tokens: List[int], max_tokens: int, first_chunk_tokens: Optional[int] = None
) -> List[List[int]]:
    """Split a token sequence into chunks of at most ``max_tokens``, each
    starting and ending with ``sil`` (the layout the acoustic model is
    trained on).  ``first_chunk_tokens`` caps chunk 0 tighter: ``stream``
    leads with a short chunk so the first audio comes sooner."""
    chunks: List[List[int]] = []
    rest = list(tokens)
    limit = min(first_chunk_tokens or max_tokens, max_tokens)
    while True:
        chunk, rest = _cut_once(rest, limit)
        chunks.append(chunk)
        if not rest:
            return chunks
        limit = max_tokens


@dataclasses.dataclass
class SynthesisResult:
    wave: np.ndarray  # [S] float32 in [-1, 1]
    mel: np.ndarray  # [T, mel_dim]
    durations: np.ndarray  # [num_tokens] seconds


def _shard_seed(seed: int, shard: int) -> int:
    """The prenet seed of batch shard ``shard`` under ``prenet_seed``
    ``seed`` (a distinct stream per shard)."""
    return int(np.random.SeedSequence([seed, shard]).generate_state(1)[0])


def _device_scope(device: torch.device):
    """``device`` made current while work is queued on it (CUDA)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _read_counters() -> List[int]:
    return [getattr(fn, name) for fn, name in _COUNTERS]


def _add_counters(counts: Sequence[int]) -> None:
    for (fn, name), n in zip(_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)


@dataclasses.dataclass
class LeadGraph:
    """The lead program of one token bucket captured as a CUDA graph: its
    static inputs, the outputs each replay overwrites, the launches each
    replay makes (``_COUNTERS`` order), the int8 scales it reads (kept
    alive with it) and the seconds its eager run and capture took."""

    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # tokens [1, T], lengths [1], sil_dur []
    outputs: Tuple[torch.Tensor, ...]  # wave [1, S], mel [1, F, mel_dim], durations [1, T], total [1]
    launches: List[int]
    act_scales: Optional[Dict[int, torch.Tensor]]
    capture_s: float


class Synthesizer:
    """Bucketed text-to-speech pipeline on one explicit ``device``, or
    data-parallel over ``devices`` (one replica of the acoustic model and
    the generator on each)."""

    # largest row (tokens) routed through the lead program; 0 turns it off
    single_dispatch_max_tokens = 64

    def __init__(
        self,
        cfg: Config = Config(),
        duration_ckpt: Optional[str | Path] = None,
        acoustic_ckpt: Optional[str | Path] = None,
        hifigan_ckpt: Optional[str | Path] = None,
        lexicon_file: Optional[str | Path] = None,
        token_buckets: Sequence[int] = DEFAULT_TOKEN_BUCKETS,
        prenet_seed: int = 42,
        *,
        device: Optional[str | torch.device] = None,
        devices: Optional[Sequence[str | torch.device]] = None,
    ):
        if (device is None) == (devices is None) or (devices is not None and not devices):
            raise TypeError("pass device= (one device) or a non-empty devices= (one replica each)")
        self.devices = [torch.device(d) for d in (devices if devices is not None else [device])]
        self.device = self.devices[0]  # the duration model's, and synthesize()'s and stream()'s
        for d in self.devices:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {d} requested but CUDA is not available")
        dtype = cfg.hifigan.inference_dtype
        if dtype not in ("float32", "bfloat16", "bf16", "int8"):
            raise ValueError(f"unknown hifigan.inference_dtype {dtype!r}")
        self.vocoder_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
        self.vocoder_quant = dtype == "int8"
        # static int8 activation scales {stage: [n_convs]}, set by
        # calibrate_int8(); None means dynamic scales
        self._act_scales: Optional[Dict[int, torch.Tensor]] = None
        self.last_clip_stats: Optional[dict] = None
        self.cfg = cfg

        ckpt_dir = Path(cfg.ckpt_dir)
        duration_ckpt = duration_ckpt or ckpt_dir / "duration_latest_ckpt.pickle"
        acoustic_ckpt = acoustic_ckpt or ckpt_dir / "acoustic_latest_ckpt.pickle"
        if hifigan_ckpt is None:
            for cand in (
                ckpt_dir / "hifigan_latest_ckpt.pickle",
                Path(cfg.hifigan_ckpt_dir) / "hk_hifi.pickle",
                ckpt_dir / "hk_hifi.pickle",
            ):
                if cand.exists():
                    hifigan_ckpt = cand
                    break
        if hifigan_ckpt is None:
            raise FileNotFoundError("no HiFi-GAN checkpoint found; pass hifigan_ckpt=")

        self.duration_model = DurationModel(cfg.duration)
        load_duration(self.duration_model, load_variables(duration_ckpt, "duration"))
        acoustic = AcousticModel(cfg.acoustic)
        load_acoustic(acoustic, load_variables(acoustic_ckpt, "acoustic"))
        generator = Generator(cfg.hifigan)
        load_generator(generator, load_variables(hifigan_ckpt, "hifigan"))
        self.acoustic_models = [acoustic] + [copy.deepcopy(acoustic) for _ in self.devices[1:]]
        self.generators = [generator] + [copy.deepcopy(generator) for _ in self.devices[1:]]
        self.duration_model.to(self.device).eval().requires_grad_(False)
        for models in (self.acoustic_models, self.generators):
            for model, d in zip(models, self.devices):
                model.to(d).eval().requires_grad_(False)
        self.acoustic_model, self.generator = acoustic, generator

        self.lexicon = load_lexicon(lexicon_file) if lexicon_file is not None else None
        self.token_buckets = tuple(token_buckets)
        self.prenet_seed = prenet_seed
        self._prenet_gens = [torch.Generator(device=d) for d in self.devices]
        # the lead program: its prenet keep masks per frame budget, and on
        # CUDA its graphs per token bucket, their memory pool and the lock
        # that serializes capture, replay and the copy of a replay's outputs
        self._lead_keeps: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.lead_graphs: Dict[int, LeadGraph] = {}
        self._graph_pool = None
        self._lead_lock = threading.Lock()
        # the frame buckets that have run per padded (rows, token bucket)
        # shape, filled by warmup() and by every bucketed dispatch; a
        # dispatch snaps up to one of them (_frame_bucket)
        self._seen_nf: Dict[Tuple[int, int], set] = {}

    # Default calibration set (the JAX package's): a greeting, a long
    # multi-clause sentence, a short exclamation and digit-heavy text, so
    # the per-conv amaxes see short, long and loud activations.
    CALIBRATION_TEXTS: Tuple[str, ...] = (
        "xin chào các bạn tôi nói tiếng Việt rất vui",
        "hôm nay trời nắng đẹp, chúng ta cùng nhau đi dạo quanh bờ hồ, "
        "ngắm hàng cây xanh và nghe tiếng chim hót líu lo trên cao",
        "tuyệt vời quá!",
        "số điện thoại là không chín tám bảy sáu năm bốn ba hai một",
    )

    @torch.inference_mode()
    def calibrate_int8(
        self,
        mel=None,
        text: Optional[str] = None,
        texts: Optional[Sequence[str]] = None,
        margin: float = 1.25,
    ) -> bool:
        """Calibrate static activation scales for the int8 vocoder route:
        per-conv amaxes of the float32 generator (``generator_calibrate_int8``)
        on ``mel`` [B, T, mel_dim] if given, else on the mels decoded from
        ``texts`` (default ``CALIBRATION_TEXTS``; ``text`` narrows it to
        one), maxed over utterances and widened by ``margin`` (1.25: ~0.2
        bit of int8 resolution against clipping on unseen input).  Returns
        True if scales were installed, False when the route is not int8.

        It runs on every device, the CPU included: the JAX package skips it
        on its CPU backend only because interpret-mode Pallas is slow
        there, which does not apply to the port's plain twins.  The scales
        are computed once, on the first device, and serve every replica."""
        if not self.vocoder_quant:
            return False
        if mel is not None:
            mels = [self._mel_tensor(mel)]
        else:
            if texts is None:
                texts = (text,) if text is not None else self.CALIBRATION_TEXTS
            mels = [self._calibration_mel(t) for t in texts]
        scales = generator_calibrate_int8(self.generator, mels[0])
        for m in mels[1:]:
            for i, s in generator_calibrate_int8(self.generator, m).items():
                scales[i] = torch.maximum(scales[i], s)
        self._act_scales = {i: s * margin for i, s in scales.items()}
        self.lead_graphs.clear()  # they read the scales they were captured with
        return True

    def _calibration_mel(self, text: str) -> torch.Tensor:
        """Decode ``text`` to a mel [1, n_frames, mel_dim] on the device
        through the serving decode path."""
        toks, lengths, dur_s = self._durations_for([self.text_to_token_ids(text)], -1.0)
        return self._decode(toks, lengths, dur_s)[0]

    @torch.inference_mode()
    def int8_clip_stats(self, mel=None, text: Optional[str] = None) -> dict:
        """Sampled out-of-range probe for the static int8 route: the
        fraction of each MRF conv input beyond its calibrated amax (which
        the kernel clips) on ``mel`` ([T, mel_dim] or [B, T, mel_dim]) or
        the mel decoded from ``text``.  Returns ``{"max_clip_fraction":
        float, "per_stage": {stage: [fractions]}}`` and keeps it as
        ``last_clip_stats`` for the server's /stats.  Costs one float32
        vocoder forward.  Raises if the route is not calibrated."""
        if self._act_scales is None:
            raise RuntimeError(
                "int8_clip_stats requires static-int8 calibration "
                "(calibrate_int8/warmup on the int8 route)"
            )
        if mel is None:
            mel = self._calibration_mel(text if text is not None else self.CALIBRATION_TEXTS[0])
        mel = self._mel_tensor(mel)
        if mel.dim() == 2:
            mel = mel[None]
        fracs = generator_int8_clip_stats(self.generator, mel, self._act_scales)
        per_stage = {int(i): v.cpu().tolist() for i, v in fracs.items()}
        stats = {
            "max_clip_fraction": max((max(v) for v in per_stage.values()), default=0.0),
            "per_stage": per_stage,
        }
        self.last_clip_stats = stats
        return stats

    @torch.inference_mode()
    def warmup(
        self,
        frame_buckets: Optional[Sequence[int]] = None,
        batch_sizes: Sequence[int] = (1,),
        token_buckets: Optional[Sequence[int]] = None,
        lead_tokens: Optional[int] = None,
        silence_durations: Sequence[float] = (),
    ) -> None:
        """Calibrate the int8 route (when it is not yet calibrated), then
        run the bucketed decode and vocoder once at each batch size, token
        bucket (default: every configured bucket) and frame bucket, so
        kernels, cuDNN plans and the caching allocator are ready before the
        first request, and each frame bucket joins the set a later dispatch
        snaps to.  There is no compile to warm: PyTorch runs eagerly.  The
        frame buckets are ``frame_buckets`` if given, else JAX's coverage
        (``_warmup_frame_buckets``: 4 and 8 frames a token, and the 2x
        steps above that for each of ``silence_durations``).  Batch sizes
        are rounded up to a multiple of the device count, as
        ``synthesize_batch`` pads them, and run sharded.

        When 1 is among the batch sizes it then runs the lead program of
        every token bucket of at most ``lead_tokens`` tokens (default:
        ``single_dispatch_max_tokens``, and none on the CPU, as JAX skips
        them on its CPU backend), which on CUDA captures each bucket's
        graph (``lead_graphs``)."""
        if self.vocoder_quant and self._act_scales is None:
            self.calibrate_int8()
        fps = self.cfg.dsp.sample_rate / self.cfg.dsp.hop_length
        n_dev = len(self.devices)
        sizes = list(dict.fromkeys(-(-b // n_dev) * n_dev for b in batch_sizes))
        buckets = tuple(token_buckets or self.token_buckets)
        for b in sizes:
            for tb in buckets:
                rows = [[SIL_INDEX] * tb] * b
                toks, lengths, _ = self._durations_for(rows, -1.0)
                for nf in frame_buckets or _warmup_frame_buckets(tb, silence_durations, fps):
                    dur_s = np.full(toks.shape, nf / tb / fps, np.float32)
                    self._finalize_shards(self._dispatch_shards(rows, toks, lengths, dur_s, int(nf)))
                    self._seen_nf.setdefault(toks.shape, set()).add(int(nf))
        if lead_tokens is None:
            lead_tokens = 0 if self.device.type == "cpu" else self.single_dispatch_max_tokens
        if lead_tokens and 1 in batch_sizes:
            for tb in buckets:
                if tb <= lead_tokens:
                    self._synthesize_single_fused([SIL_INDEX] * max(tb - 1, 1), -1.0)

    def text_to_token_ids(self, text: str) -> List[int]:
        return text_to_tokens(normalize_text(text), self.lexicon)

    def _mel_tensor(self, mel) -> torch.Tensor:
        """A float32 mel on the first device, from numpy or torch."""
        if not isinstance(mel, torch.Tensor):
            mel = torch.as_tensor(np.asarray(mel, np.float32))
        return mel.to(self.device, torch.float32)

    def _vocode(self, mels: torch.Tensor, replica: int = 0) -> torch.Tensor:
        scales = self._act_scales
        if scales is not None and self.devices[replica] != self.device:
            scales = {i: s.to(self.devices[replica]) for i, s in scales.items()}
        return generator_apply_fused(
            self.generators[replica], mels, self.vocoder_dtype,
            quantize_int8=self.vocoder_quant, act_scales=scales,
        )

    @torch.inference_mode()
    def vocode(self, mel) -> np.ndarray:
        """Log-mel [B, T, mel_dim] -> waveform [B, T * hop] float32."""
        mel = self._mel_tensor(mel)
        if mel.dim() != 3:
            raise ValueError(f"expected [B, T, mel_dim], got {tuple(mel.shape)}")
        return self._vocode(mel)[..., 0].cpu().numpy()

    @torch.inference_mode()
    def _durations_for(
        self, token_rows: List[List[int]], silence_duration: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Predict + postprocess durations.  Returns (padded token ids
        [B, T], lengths [B], durations-in-seconds [B, T])."""
        B = len(token_rows)
        T = _bucket_tokens(max(len(r) for r in token_rows), self.token_buckets)
        toks = np.zeros((B, T), np.int32)
        lengths = np.zeros((B,), np.int32)
        for i, row in enumerate(token_rows):
            toks[i, : len(row)] = row
            lengths[i] = len(row)
        batch = DurationBatch(
            torch.as_tensor(toks, dtype=torch.long, device=self.device),
            torch.as_tensor(lengths, dtype=torch.long, device=self.device),
            None,
        )
        durations = self.duration_model(batch).cpu().numpy()
        # clamp silences, zero word-end markers and padding
        if silence_duration >= 0:
            durations = np.where(
                toks == SIL_INDEX, np.clip(durations, silence_duration, None), durations
            )
        durations = np.where(toks == WORD_END_INDEX, 0.0, durations)
        mask = np.arange(T)[None, :] < lengths[:, None]
        durations = np.where(mask, durations, 0.0).astype(np.float32)
        return toks, lengths, durations

    def synthesize(self, text: str, silence_duration: float = -1.0) -> SynthesisResult:
        """Synthesize one text.  A text of at most
        ``single_dispatch_max_tokens`` tokens takes the lead program (the
        bucketed path when its frame budget overflows).  Inputs longer than
        ``cfg.data.max_phoneme_seq_len`` tokens are split at silence
        boundaries, synthesized as one padded batch, and concatenated."""
        tokens = self.text_to_token_ids(text)
        max_tokens = self.cfg.data.max_phoneme_seq_len
        if len(tokens) <= max_tokens:
            if len(tokens) <= self.single_dispatch_max_tokens:
                res = self._synthesize_single_fused(tokens, silence_duration)
                if res is not None:
                    return res
            return self._synthesize_rows([tokens], silence_duration)[0]
        parts = self._synthesize_rows(_chunk_token_rows(tokens, max_tokens), silence_duration)
        return SynthesisResult(
            wave=np.concatenate([p.wave for p in parts]),
            mel=np.concatenate([p.mel for p in parts], axis=0),
            durations=np.concatenate([p.durations for p in parts]),
        )

    @torch.inference_mode()
    def stream(self, text: str, silence_duration: float = -1.0, lead_tokens: int = 64):
        """Streaming synthesis: yield one ``SynthesisResult`` per chunk of
        ``text``, split at silence boundaries as ``synthesize`` splits
        long inputs, with chunk 0 cut at ``lead_tokens`` (0: no shorter
        lead chunk) so the first audio pays for a short decode.

        Chunk 0 takes the lead program when ``lead_tokens`` is set and it
        has at most ``single_dispatch_max_tokens`` tokens (with the
        defaults, always), falling back to the bucketed path on overflow.
        Durations for every other chunk are then predicted in one batch.
        A bucketed chunk 0's decode (padded to its own token bucket) and
        vocoder run are queued and fetched at once, so the first audio
        waits for no other chunk.  From chunk 1 on, each chunk is queued on
        the device, with its copy to pinned host memory, before the
        previous one is fetched, so the card computes chunk i+1 while the
        caller consumes chunk i.  With prenet dropout off the concatenated
        waves equal ``synthesize(text)`` where both split the text alike
        and take the same path (texts of up to ``lead_tokens`` tokens, or
        at most ``max_phoneme_seq_len`` tokens a chunk on the bucketed
        path)."""
        tokens = self.text_to_token_ids(text)
        rows = _chunk_token_rows(
            tokens, self.cfg.data.max_phoneme_seq_len, first_chunk_tokens=lead_tokens or None
        )
        if lead_tokens and len(rows[0]) <= self.single_dispatch_max_tokens:
            lead = self._synthesize_single_fused(rows[0], silence_duration)
            if lead is not None:
                yield lead
                rows = rows[1:]
                if not rows:
                    return
        toks, lengths, dur_s = self._durations_for(rows, silence_duration)

        def dispatch(i):
            # the encoder and durations of a row do not depend on padding
            # beyond its own token bucket
            t = _bucket_tokens(len(rows[i]), self.token_buckets)
            return self._dispatch([rows[i]], toks[i : i + 1, :t], lengths[i : i + 1], dur_s[i : i + 1, :t])

        yield self._finalize(dispatch(0))[0]
        pending = None
        for i in range(1, len(rows)):
            handle = dispatch(i)
            if pending is not None:
                yield self._finalize(pending)[0]
            pending = handle
        if pending is not None:
            yield self._finalize(pending)[0]

    @torch.inference_mode()
    def synthesize_batch(
        self, texts: Sequence[str], silence_duration: float = -1.0
    ) -> List[SynthesisResult]:
        """Synthesize a batch of texts as one padded batch; the batch is
        padded with one-token silent rows up to a power of two, as in the
        JAX pipeline, then to a multiple of the device count, and those
        rows are dropped from the results.  With several devices each
        takes an equal shard of the rows.  One short text takes the lead
        program on the first device, as in ``synthesize``."""
        token_rows = [self.text_to_token_ids(t) for t in texts]
        n = len(token_rows)
        if n == 1 and len(token_rows[0]) <= self.single_dispatch_max_tokens:
            res = self._synthesize_single_fused(token_rows[0], silence_duration)
            if res is not None:
                return [res]
        bucket = 1
        while bucket < n:
            bucket *= 2
        bucket = -(-bucket // len(self.devices)) * len(self.devices)
        token_rows = token_rows + [[SIL_INDEX]] * (bucket - n)
        toks, lengths, dur_s = self._durations_for(token_rows, silence_duration)
        return self._finalize_shards(self._dispatch_shards(token_rows, toks, lengths, dur_s))[:n]

    @torch.inference_mode()
    def _synthesize_rows(
        self, token_rows: List[List[int]], silence_duration: float = -1.0
    ) -> List[SynthesisResult]:
        """Rows on the first device."""
        toks, lengths, dur_s = self._durations_for(token_rows, silence_duration)
        return self._finalize(self._dispatch(token_rows, toks, lengths, dur_s))

    # ------------------------------------------------------------------
    # the single-dispatch lead program

    def _lead_program(self, toks: torch.Tensor, lengths: torch.Tensor, sil_dur: torch.Tensor, n_frames: int):
        """One token row through the whole chain on the first device, with
        no host read: durations, JAX's postprocessing (the silence clamp
        at ``sil_dur``, off below 0, so one program serves every value;
        word-end markers and padding zeroed), the decode of ``n_frames``
        frames and the vocoder of the route.  toks [1, T] and lengths [1]
        long, sil_dur a float32 scalar; returns wave [1, n_frames * hop],
        mel [1, n_frames, mel_dim], durations [1, T] (seconds) and the
        frame total [1]."""
        durs = self.duration_model(DurationBatch(toks, lengths, None))
        clamp = (sil_dur >= 0) & (toks == SIL_INDEX)
        durs = torch.where(clamp, torch.maximum(durs, sil_dur), durs)
        durs = torch.where(toks == WORD_END_INDEX, 0.0, durs)
        mask = torch.arange(toks.shape[1], device=toks.device)[None, :] < lengths[:, None]
        durs = torch.where(mask, durs, 0.0)
        dur_frames = durs * (self.cfg.dsp.sample_rate / self.cfg.dsp.hop_length)
        keep1, keep2 = self._lead_keep(n_frames)
        mel = self.acoustic_model.inference(toks, dur_frames, n_frames, lengths, keep1=keep1, keep2=keep2)
        return self._vocode(mel)[..., 0], mel, durs, dur_frames.sum(dim=1)

    def _lead_keep(self, n_frames: int):
        """The lead program's prenet keep masks [n_frames, 1, prenet_dim]
        for a frame budget: drawn once from ``prenet_seed`` as ``_decode``
        draws them, then kept (a graph replays them; a draw inside it
        would advance the generator on every replay).  None, None with
        prenet dropout off."""
        acfg = self.cfg.acoustic
        if not acfg.prenet_dropout_at_inference:
            return None, None
        keeps = self._lead_keeps.get(n_frames)
        if keeps is None:
            gen = torch.Generator(device=self.device).manual_seed(self.prenet_seed)
            shape, keep_prob = (n_frames, 1, acfg.prenet_dim), 1.0 - acfg.prenet_dropout_rate
            keeps = tuple(torch.rand(shape, generator=gen, device=self.device) < keep_prob for _ in range(2))
            self._lead_keeps[n_frames] = keeps
        return keeps

    def _lead_replay(self, T: int, n_frames: int, host_inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Run token bucket T's lead graph on ``host_inputs`` (tokens,
        lengths, sil_dur) and return its outputs in pinned host memory.
        The graph is captured on the bucket's first use (and again when
        the int8 scales change), after one eager run of the program on the
        same inputs that prepares every kernel outside the capture.  The
        lock covers capture, replay and the copies: the next replay
        overwrites the outputs."""
        with self._lead_lock, _device_scope(self.device):
            lead = self.lead_graphs.get(T)
            if lead is None or lead.act_scales is not self._act_scales:
                lead = self.lead_graphs[T] = self._capture_lead(n_frames, host_inputs)
            for static, host in zip(lead.inputs, host_inputs):
                static.copy_(host, non_blocking=True)
            lead.graph.replay()
            _add_counters(lead.launches)
            outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                    for t in lead.outputs]
            event = torch.cuda.Event()
            event.record()
            event.synchronize()
        return outs

    def _capture_lead(self, n_frames: int, host_inputs: Sequence[torch.Tensor]) -> LeadGraph:
        """Capture the lead program for ``n_frames`` frames into a new CUDA
        graph in the shared pool; its launches are taken off the counters
        (a capture launches nothing) and added back by each replay.  A
        failed capture raises."""
        t0 = time.perf_counter()
        inputs = tuple(h.to(self.device) for h in host_inputs)
        self._lead_program(*inputs, n_frames)  # prepares K1, K2/K3 opt-ins, cuBLAS and cuDNN
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = _read_counters()
        with torch.cuda.graph(graph, pool=self._graph_pool, capture_error_mode="thread_local"):
            outputs = self._lead_program(*inputs, n_frames)
        launches = [a - b for a, b in zip(_read_counters(), before)]
        _add_counters([-n for n in launches])
        return LeadGraph(graph, inputs, outputs, launches, self._act_scales, time.perf_counter() - t0)

    @torch.inference_mode()
    def _synthesize_single_fused(self, row: List[int], silence_duration: float) -> Optional[SynthesisResult]:
        """Synthesize one token row through the lead program (JAX's
        ``_synthesize_single_fused``): decode ``LEAD_FRAMES_PER_TOKEN``
        frames a token of its bucket, one set of copies to the host at the
        end.  Returns None when the predicted frame total overflows that
        budget, and on the CPU unless both ``acoustic.fused_decode`` and
        ``hifigan.fused_inference`` are off (JAX's CPU gate); the caller
        then takes the bucketed path."""
        if self.device.type == "cpu" and (self.cfg.acoustic.fused_decode or self.cfg.hifigan.fused_inference):
            return None
        T = _bucket_tokens(len(row), self.token_buckets)
        n_frames = _bucket_frames(T * LEAD_FRAMES_PER_TOKEN)
        toks = torch.zeros(1, T, dtype=torch.long)
        toks[0, : len(row)] = torch.as_tensor(row, dtype=torch.long)
        inputs = (toks, torch.tensor([len(row)], dtype=torch.long), torch.tensor(silence_duration, dtype=torch.float32))
        if self.device.type == "cuda":
            wave, mel, durs, total = self._lead_replay(T, n_frames, [t.pin_memory() for t in inputs])
        else:
            wave, mel, durs, total = self._lead_program(*(t.to(self.device) for t in inputs), n_frames)
        total = total.numpy()
        if float(total[0]) + 1 > n_frames:
            return None
        return self._finalize(([row], mel, wave, durs.numpy(), total, None))[0]

    def _frames(self, dur_s: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
        """Durations (seconds) -> (frames, each row's frame total, the
        natural frame bucket: the smallest that holds every row)."""
        dur_frames = dur_s * (self.cfg.dsp.sample_rate / self.cfg.dsp.hop_length)
        total_frames = dur_frames.sum(axis=1)
        return dur_frames, total_frames, _bucket_frames(int(np.max(total_frames)) + 1)

    def _frame_bucket(self, shape: Tuple[int, int], dur_s: np.ndarray) -> int:
        """The frame bucket a bucketed dispatch of ``shape`` (rows, token
        bucket) decodes, as JAX's ``_dispatch_decode`` picks it: its
        natural bucket if that has run at this shape; else the smallest
        bucket that has run there, holds every row and is at most twice the
        natural one; else the natural bucket, which then joins the set.
        The rows are counted padded to the device count (JAX's global batch
        under a mesh, which also replicates a ``stream`` chunk over it)."""
        _, total_frames, n_frames = self._frames(dur_s)
        needed = int(np.max(total_frames)) + 1
        n_dev = len(self.devices)
        seen = self._seen_nf.setdefault((-(-shape[0] // n_dev) * n_dev, shape[1]), set())
        if n_frames not in seen:
            snap = [f for f in seen if needed <= f <= 2 * n_frames]
            if snap:
                return min(snap)
            seen.add(n_frames)
        return n_frames

    def _decode(self, toks, lengths, dur_s, replica: int = 0, n_frames: Optional[int] = None,
                seed: Optional[int] = None) -> Tuple[torch.Tensor, np.ndarray]:
        """AR-decode padded rows with known durations (seconds) on replica
        ``replica``: mels [B, n_frames, mel_dim] on its device (``n_frames``
        defaults to the rows' natural bucket) and each row's frame total.  The
        prenet masks are drawn from ``seed`` (default ``prenet_seed``)."""
        dur_frames, total_frames, bucket = self._frames(dur_s)
        device, gen = self.devices[replica], self._prenet_gens[replica]
        gen.manual_seed(self.prenet_seed if seed is None else seed)
        mels = self.acoustic_models[replica].inference(
            self._upload(toks, torch.long, device),
            self._upload(dur_frames, torch.float32, device),
            n_frames or bucket,
            self._upload(lengths, torch.long, device),
            generator=gen,
        )
        return mels, total_frames

    def _upload(self, a: np.ndarray, dtype: torch.dtype, device: Optional[torch.device] = None) -> torch.Tensor:
        """A host array on ``device`` (the first by default).  On CUDA it
        goes through pinned memory without blocking: a copy from pageable
        memory would wait for the work already queued on the stream."""
        device = device or self.device
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _dispatch(self, token_rows, toks, lengths, dur_s, replica: int = 0, n_frames: Optional[int] = None,
                  seed: Optional[int] = None):
        """Queue decode + vocoder for rows with known durations on replica
        ``replica`` and start the copies of mels and waves to the host,
        without waiting for them; ``_finalize`` waits.  ``n_frames``
        defaults to ``_frame_bucket`` of the rows.  On CUDA the copies go
        to pinned memory and an event on the replica's device marks their
        end."""
        device = self.devices[replica]
        if n_frames is None:
            n_frames = self._frame_bucket(toks.shape, dur_s)
        with _device_scope(device):
            mels, total_frames = self._decode(toks, lengths, dur_s, replica, n_frames, seed)
            waves = self._vocode(mels, replica)[..., 0]
            event = None
            if device.type == "cuda":
                mels, waves = (
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                    for t in (mels, waves)
                )
                event = torch.cuda.Event()
                event.record()
        return token_rows, mels, waves, dur_s, total_frames, event

    def _dispatch_shards(self, token_rows, toks, lengths, dur_s, n_frames: Optional[int] = None) -> List:
        """``_dispatch`` of an equal shard of the rows on every replica, all
        queued before any is waited for, with one frame budget for all
        (``n_frames``, default ``_frame_bucket`` of the whole batch); one
        device dispatches the rows whole."""
        n_dev = len(self.devices)
        if n_frames is None:
            n_frames = self._frame_bucket(toks.shape, dur_s)
        if n_dev == 1:
            return [self._dispatch(token_rows, toks, lengths, dur_s, 0, n_frames)]
        if len(token_rows) % n_dev:
            raise ValueError(f"{len(token_rows)} rows do not shard over {n_dev} devices")
        k = len(token_rows) // n_dev
        return [
            self._dispatch(token_rows[i * k:(i + 1) * k], toks[i * k:(i + 1) * k], lengths[i * k:(i + 1) * k],
                           dur_s[i * k:(i + 1) * k], i, n_frames, _shard_seed(self.prenet_seed, i))
            for i in range(n_dev)
        ]

    def _finalize_shards(self, handles) -> List[SynthesisResult]:
        return [r for h in handles for r in self._finalize(h)]

    def _finalize(self, handle) -> List[SynthesisResult]:
        """Wait for a dispatched batch and trim each row."""
        token_rows, mels, waves, dur_s, total_frames, event = handle
        if event is not None:
            event.synchronize()
        waves, mels = waves.numpy(), mels.numpy()
        cfg = self.cfg
        frames_per_sec = cfg.dsp.sample_rate / cfg.dsp.hop_length
        hop = cfg.dsp.hop_length
        results = []
        for i, row in enumerate(token_rows):
            keep = int(total_frames[i])
            # trailing-silence trim (reference text2mel.py:99-102)
            if row and row[-1] == SIL_INDEX:
                sil_frames = int(dur_s[i, len(row) - 1] * frames_per_sec)
                keep = max(keep - sil_frames, 1)
            results.append(
                SynthesisResult(
                    wave=waves[i, : keep * hop],
                    mel=mels[i, :keep],
                    durations=dur_s[i, : len(row)],
                )
            )
        return results
