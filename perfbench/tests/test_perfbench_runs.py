"""Whole runs of the harness on the CPU at tiny widths (the look for a
card skipped, the plain twins in the kernels' place): each driver's run is
correct, and a run whose timed path is broken underneath is not."""

import time

import pytest
import torch

from perfbench.harness.core import run_cell
from tiny import tiny_cell

CPU = torch.device("cpu")


def _run(cell, seed=2**31 + 11, seconds=1.5):
    torch.manual_seed(0)
    return run_cell(cell, seed, seconds, False, CPU, time.perf_counter(), log=lambda *a, **k: None)


@pytest.mark.parametrize("name", ["infore.bulk64", "tacotron2.stream"])
def test_a_sound_run_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["run"]["compared_rows"] >= 1 and res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {m for m in res["metrics"]} >= {"setup_s"}


def test_the_float32_route_matches_the_reference_vocoder():
    cell = tiny_cell("infore.bulk64")
    cell.config["sizes"]["hifigan.inference_dtype"] = "float32"
    res = _run(cell)
    assert res["checks"]["wave_gap"]["value"] < 1e-4
    assert res["checks"]["mel_gap"]["value"] < 1e-4 and res["checks"]["dur_gap"]["value"] < 1e-4


def _swap_rows(monkeypatch):
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    real = Synthesizer._finalize

    def finalize(self, handle):
        out = real(self, handle)
        if len(out) > 1:  # two answers swapped where they are produced
            out[0].wave, out[1].wave = out[1].wave, out[0].wave
        return out

    monkeypatch.setattr(Synthesizer, "_finalize", finalize)


def _half_batch(monkeypatch):
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    real = Synthesizer.synthesize_batch

    def synthesize_batch(self, texts, silence_duration=-1.0):
        return real(self, texts, silence_duration)[: max(1, len(texts) // 2)]

    monkeypatch.setattr(Synthesizer, "synthesize_batch", synthesize_batch)


def _frozen_decode(monkeypatch):
    import viettts_tpu_torch.models.acoustic as acoustic

    real = acoustic.ar_decode

    def ar_decode(g1c, *args, **kw):  # every frame the first: the state never advances
        mel = real(g1c, *args, **kw)
        return mel[:, :1].expand_as(mel).contiguous()

    monkeypatch.setattr(acoustic, "ar_decode", ar_decode)


def _altered_durations(monkeypatch):
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    real = Synthesizer._durations_for

    def durations_for(self, rows, silence_duration):
        toks, lengths, dur = real(self, rows, silence_duration)
        dur = dur.copy()
        dur[:, 1] *= 1.5  # one token's duration altered where it is produced
        return toks, lengths, dur

    monkeypatch.setattr(Synthesizer, "_durations_for", durations_for)


@pytest.mark.parametrize("fault", [_swap_rows, _half_batch, _frozen_decode, _altered_durations])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tiny_cell("infore.bulk64"))
    assert not res["correct"], res["checks"]
