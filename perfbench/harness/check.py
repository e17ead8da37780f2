"""Whether what the timed path returned is right: the plain reference
(``perfbench/reference``) worked out again for a sample of the window's own
requests, at the sizes they were served at.

The reference replays every dispatch of the run in order, from the
warm-up on, to work out what the program derives: each text's tokens, its
batch's padding, which path it took (the lead program or a bucketed
dispatch), the frame budget the dispatch decoded (the frame-bucket sets
that warm-up and earlier dispatches left), the prenet's keep masks, and
each row's kept length.  For the sampled rows it then computes:

* the durations, from its own tokens, padded as the batch was;
* the log-mel, decoding the frame budget from the program's durations
  (the duration stage is judged by itself just above, so a small duration
  difference does not move every later frame);
* the waveform, vocoding the program's log-mel of the kept frames (then
  its own frames past them, which the program decoded and did not return),
  at the vocoder precision the configuration states.

Each stage is thus judged by itself, from the program's output of the
stage before: the durations from the tokens, the log-mel from the served
durations, the waveform from the served log-mel.

Numbers compared (each with its limit in ``perfbench/limits/<cell>.json``):
``dur_gap`` the widest duration difference over the typical duration;
``mel_gap`` the worst row's RMS difference over the reference's RMS;
``wave_gap`` the RMS difference of the compared rows' waveforms from the
reference at the stated precision, in units of that reference's own RMS
distance from the float32 vocoder on the same rows (the stated precision's
rounding noise on these weights, which alone spread the raw difference
fourfold across seeds), pooled over the rows; ``length_gap`` rows or chunks whose token count, chunking
or kept length differ from the reference's; ``missing`` requests due that
never got an answer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import frontend, plan
from perfbench.reference.model import Reference, keep_masks, precision

GROUP_ROWS = 8  # rows the reference decodes at once


@dataclasses.dataclass
class Item:
    """A sampled row (or chunk) and how the program served it."""

    tokens: List[int]
    t_dur: int  # token bucket its durations were computed at
    t_dec: int  # token bucket its decode ran at
    rows: int  # rows of its dispatch (the keep masks' batch)
    row: int  # its row in the dispatch
    n_frames: int
    total: float  # frame total as the host sums it
    out: object  # drivers.Output


def _near_int(x: float, tol: float = 1e-3) -> bool:
    return abs(x - round(x)) < tol


def replay(dispatches, warmup: List[dict], fps: float, lead_tokens: int = plan.LEAD_MAX_TOKENS):
    """(items, structural mismatches): the sampled rows with their
    dispatch shapes, and the dispatches whose returned rows or chunks do
    not match the reference's tokens and chunking."""
    fb = plan.FrameBuckets()
    for w in warmup:
        for b in w["batch_sizes"]:
            for tb in w["token_buckets"]:
                for nf in w.get("frame_buckets") or plan.warmup_frame_buckets(tb):
                    fb.add((b, tb), nf)
    items: List[Item] = []
    mismatches: List[str] = []

    def lead(row_tokens, durations):
        T = plan.bucket_tokens(len(row_tokens))
        nf = plan.bucket_frames(T * plan.LEAD_FRAMES_PER_TOKEN)
        total = float(plan.frame_totals([durations], T, fps)[0])
        return (T, nf, total) if total + 1 <= nf else None

    for k, d in enumerate(dispatches):
        if d.kind == "batch":
            toks = [frontend.tokens(t) for t in d.texts]
            if len(d.durations) != len(toks) or any(len(a) != len(b) for a, b in zip(toks, d.durations)):
                mismatches.append(f"dispatch {k}: {len(d.durations)} rows returned for {len(toks)} texts, "
                                  "or a row's token count is not the reference's")
                continue
            if len(toks) == 1 and len(toks[0]) <= lead_tokens:
                got = lead(toks[0], d.durations[0])
                if got is not None:
                    T, nf, total = got
                    for i, out in d.sampled.items():
                        items.append(Item(toks[0], T, T, 1, 0, nf, total, out))
                    continue
            B = plan.batch_rows(len(toks))
            T = plan.bucket_tokens(max(len(t) for t in toks))
            totals = plan.frame_totals(d.durations, T, fps)
            nf = fb.pick((B, T), totals)
            for i, out in d.sampled.items():
                items.append(Item(toks[i], T, T, B, i, nf, float(totals[i]), out))
        else:
            toks = frontend.tokens(d.texts[0])
            rows = plan.chunks(toks, plan.MAX_TOKENS, first=lead_tokens)
            if len(rows) != len(d.durations) or any(len(a) != len(b) for a, b in zip(rows, d.durations)):
                mismatches.append(f"stream {k}: {len(d.durations)} chunks returned, the reference cuts {len(rows)}")
                continue
            first = 0
            if len(rows[0]) <= lead_tokens:
                got = lead(rows[0], d.durations[0])
                if got is not None:
                    T, nf, total = got
                    if 0 in d.sampled:
                        items.append(Item(rows[0], T, T, 1, 0, nf, total, d.sampled[0]))
                    first = 1
            rest = rows[first:]
            if not rest:
                continue
            T_dur = plan.bucket_tokens(max(len(r) for r in rest))
            for j, row in enumerate(rest, start=first):
                t = plan.bucket_tokens(len(row))
                total = plan.frame_totals([d.durations[j]], t, fps)
                nf = fb.pick((1, t), total)
                if j in d.sampled:
                    items.append(Item(row, T_dur, t, 1, 0, nf, float(total[0]), d.sampled[j]))
    return items, mismatches


def _pad(rows: List[List[int]], T: int, device) -> torch.Tensor:
    out = torch.zeros(len(rows), T, dtype=torch.long)
    for i, r in enumerate(rows):
        out[i, :len(r)] = torch.as_tensor(r)
    return out.to(device)


def _rel_rms(a: np.ndarray, b: np.ndarray) -> float:
    den = float(np.sqrt(np.mean(np.square(b.astype(np.float64))))) if b.size else 0.0
    if a.shape != b.shape or den == 0.0:
        return float("inf")
    return float(np.sqrt(np.mean(np.square(a.astype(np.float64) - b))) / den)


def reference_outputs(ref: Reference, items: List[Item], sizes, prenet_seed: int, dtype: str = "float32",
                      vocoder_input: Optional[List[np.ndarray]] = None, vocoder_dtype: Optional[str] = None):
    """For each item: (durations [n], mel [n_frames, D], wave [n_frames * hop],
    exact wave) of the reference at ``dtype``: the mel decoded from the
    program's durations, the wave vocoded at the stated vocoder precision
    from ``vocoder_input[i]`` (a served mel of the kept frames) where given,
    followed by the reference's own frames, else from the reference's own
    mel; the exact wave is the same vocoded in float32."""
    device = ref.device
    fps = ref.fps
    P = sizes["acoustic.prenet_dim"]
    keep_prob = 1.0 - sizes["acoustic.prenet_dropout_rate"]
    durs: Dict[int, np.ndarray] = {}
    mels: Dict[int, torch.Tensor] = {}
    waves: Dict[int, np.ndarray] = {}
    exact: Dict[int, np.ndarray] = {}
    with precision(device, dtype):
        by_dur: Dict[int, List[int]] = {}
        for i, it in enumerate(items):
            by_dur.setdefault(it.t_dur, []).append(i)
        for T, idx in by_dur.items():
            for g in range(0, len(idx), GROUP_ROWS):
                part = idx[g:g + GROUP_ROWS]
                toks = _pad([items[i].tokens for i in part], T, device)
                lengths = torch.tensor([len(items[i].tokens) for i in part], device=device)
                d = ref.durations(toks, lengths).float().cpu().numpy()
                for j, i in enumerate(part):
                    durs[i] = d[j, :len(items[i].tokens)]
        by_dec: Dict[tuple, List[int]] = {}
        for i, it in enumerate(items):
            by_dec.setdefault((it.n_frames, it.t_dec, it.rows), []).append(i)
        for (nf, T, B), idx in by_dec.items():
            masks = keep_masks(prenet_seed, nf, B, P, keep_prob, device)
            for g in range(0, len(idx), GROUP_ROWS):
                part = idx[g:g + GROUP_ROWS]
                toks = _pad([items[i].tokens for i in part], T, device)
                lengths = torch.tensor([len(items[i].tokens) for i in part], device=device)
                frames = np.zeros((len(part), T), np.float32)
                for j, i in enumerate(part):
                    prog = items[i].out.durations
                    frames[j, :len(prog)] = prog * np.float32(fps)
                sel = torch.tensor([items[i].row for i in part], device=device)
                k1, k2 = (m.index_select(1, sel) for m in masks)
                mel = ref.mel(toks, lengths, torch.as_tensor(frames, device=device), nf, k1, k2, keep_prob)
                mel_in = mel.clone()
                if vocoder_input is not None:
                    for j, i in enumerate(part):
                        served = torch.as_tensor(vocoder_input[i][:nf], device=device)
                        mel_in[j, :served.shape[0]] = served
                wave = ref.wave(mel_in, vocoder_dtype).float().cpu().numpy()
                wave32 = ref.wave(mel_in, "float32").float().cpu().numpy()
                for j, i in enumerate(part):
                    mels[i] = mel[j].float().cpu().numpy()
                    waves[i], exact[i] = wave[j], wave32[j]
    return [(durs[i], mels[i], waves[i], exact[i]) for i in range(len(items))]


def gaps(items: List[Item], outputs, ref_outputs, sizes) -> Dict[str, float]:
    """The numbers compared, of ``outputs`` (each item's (durations, mel,
    wave) as served) against ``ref_outputs``."""
    hop = sizes["dsp.hop_length"]
    fps = sizes["dsp.sample_rate"] / hop
    dur_gap = mel_gap = worst_row = 0.0
    length_gap = 0
    wave_err = wave_unit = 0.0  # summed squares over the rows: the difference, the unit
    typical = float(np.median(np.concatenate([r[0][r[0] > 0] for r in ref_outputs]))) if ref_outputs else 1.0
    for it, (d, mel, wave), (rd, rmel, rwave, rexact) in zip(items, outputs, ref_outputs):
        if d.shape != rd.shape:
            length_gap += 1
            continue
        dur_gap = max(dur_gap, float(np.max(np.abs(d.astype(np.float64) - rd))) / typical)
        keep = plan.kept_frames(it.tokens, it.total, float(it.out.durations[-1]), fps)
        got = len(wave) // hop
        if got != keep:
            last = float(np.float32(it.out.durations[-1]) * np.float32(fps))
            if not (abs(got - keep) == 1 and (_near_int(it.total) or _near_int(last))):
                length_gap += 1
        n = min(got, keep, rmel.shape[0])
        mel_gap = max(mel_gap, _rel_rms(mel[:n], rmel[:n]))
        w, rw, rx = (v[:n * hop].astype(np.float64) for v in (wave, rwave, rexact))
        # the unit: the stated precision's own distance from float32 (the row itself where it is float32)
        err = float(np.sum(np.square(w - rw))) if w.shape == rw.shape else float("inf")
        unit = float(np.sum(np.square(rw if np.array_equal(rw, rx) else rw - rx)))
        wave_err, wave_unit = wave_err + err, wave_unit + unit
        worst_row = max(worst_row, np.sqrt(err / unit) if unit > 0 else float("inf"))
    wave_gap = float(np.sqrt(wave_err / wave_unit)) if wave_unit > 0 else (0.0 if wave_err == 0 else float("inf"))
    return {"dur_gap": dur_gap, "mel_gap": mel_gap, "wave_gap": wave_gap, "length_gap": float(length_gap),
            "wave_gap_worst_row": float(worst_row)}


def check(record, trees, sizes, warmup, prenet_seed: int, device, models,
          control: Optional[str] = None) -> Dict[str, float]:
    """The numbers compared for a finished run (``drivers.Record``), by the
    configuration's model modules (``cells.Models``).  A
    ``control`` puts the reference in the program's place on the same
    items, at a lower precision: ``bfloat16`` (autocast) for every stage,
    ``float8`` (e4m3) for the vocoder alone."""
    fps = sizes["dsp.sample_rate"] / sizes["dsp.hop_length"]
    items, mismatches = replay(record.dispatches, warmup, fps)
    ref = Reference(trees, sizes, device, models)
    hop = sizes["dsp.hop_length"]
    if control is None:
        served = [(it.out.durations, it.out.mel, it.out.wave) for it in items]
    elif control == "float8":  # the reference vocoder in e4m3 in the program's place, on the served mel
        low = reference_outputs(ref, items, sizes, prenet_seed, vocoder_input=[it.out.mel for it in items],
                                vocoder_dtype="float8")
        served = [(it.out.durations, it.out.mel, w[:len(it.out.wave)]) for it, (_, _, w, _) in zip(items, low)]
    else:
        low = reference_outputs(ref, items, sizes, prenet_seed, control)
        served = [(d, m[:len(it.out.wave) // hop], w[:len(it.out.wave)]) for it, (d, m, w, _) in zip(items, low)]
    # each stage from the served output of the one before: the vocoder from the served mel
    ref_out = reference_outputs(ref, items, sizes, prenet_seed, vocoder_input=[m for _, m, _ in served])
    out = gaps(items, served, ref_out, sizes)
    out["length_gap"] += len(mismatches)
    out["missing"] = float(record.failed)
    out["compared_rows"] = float(len(items))
    out["compared_tokens"] = float(sum(len(it.tokens) for it in items))
    out["mismatches"] = mismatches
    return out
