"""The spans of the port's serving path (``viettts_tpu_torch.utils.profiling``)
on a tiny seeded Synthesizer on the CPU: what records when, how spans nest
and share a trace id, the counts they carry, their clock against the
profiler's, the set-up spans, and the server's."""

import sys
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from viettts_tpu_torch import serve
from viettts_tpu_torch.config import DataConfig
from viettts_tpu_torch.infer import pipeline
from viettts_tpu_torch.ops import _build
from viettts_tpu_torch.utils import profiling
from tests.test_torch_pipeline import _cfg, _write_checkpoints, port_config

TEXTS = ["một hai ba", "bốn năm sáu bảy tám chín mười"]
STREAM_TEXT = "xin chào các bạn. hôm nay trời đẹp, chúng ta đi chơi nhé"
SETUP = ("setup.synthesizer", "setup.checkpoint", "setup.models", "setup.warmup", "setup.library",
         "lead.capture")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_spans_ckpts"))
    # chunks of at most 16 tokens, so that a stream has bucketed chunks after its lead
    cfg = _cfg(d).replace(data=DataConfig(max_phoneme_seq_len=16))
    return pipeline.Synthesizer(port_config(cfg), device="cpu")


def _per_request(records):
    return [r for r in records if r.name not in SETUP]


def _self_ns(records):
    """Each span's duration less its children's."""
    own = {r.id: r.end - r.start for r in records}
    for r in records:
        if r.parent in own:
            own[r.parent] -= r.end - r.start
    return own


def test_nothing_records_while_recording_is_off(synth):
    profiling.clear()
    synth.synthesize_batch(TEXTS)
    chunks = list(synth.stream(STREAM_TEXT))
    assert len(chunks) >= 2
    assert _per_request(profiling.spans()) == []


def test_a_batch_records_its_stages_under_one_trace(synth, monkeypatch):
    budgets = []  # each dispatch's frame budget
    decode = synth._decode

    def spy(toks, lengths, dur_s, replica=0, n_frames=None, seed=None):
        budgets.append(n_frames)
        return decode(toks, lengths, dur_s, replica, n_frames, seed)

    monkeypatch.setattr(synth, "_decode", spy)
    profiling.clear()
    with profiling.recording():
        results = synth.synthesize_batch(TEXTS)
    records = profiling.spans()
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["synth.batch"]
    root = roots[0]
    assert root.attrs == {}
    assert {r.trace for r in records} == {root.trace}
    names = [r.name for r in sorted(records, key=lambda r: r.start)]
    assert names == ["synth.batch", "synth.tokens", "synth.durations", "synth.durations.fetch", "synth.dispatch",
                     "synth.decode", "synth.vocode", "synth.finalize"]
    kinds = {r.name: r.kind for r in records}
    assert kinds["synth.durations"] == kinds["synth.decode"] == kinds["synth.vocode"] == "issue"
    assert kinds["synth.durations.fetch"] == "wait" and kinds["synth.finalize"] == "host"
    by_id = {r.id: r for r in records}
    for r in records:  # each child inside its parent
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start <= r.start <= r.end <= p.end
    own = _self_ns(records)
    assert all(v >= 0 for v in own.values())
    assert sum(own.values()) == root.end - root.start
    finalize = next(r for r in records if r.name == "synth.finalize")
    hop = synth.cfg.dsp.hop_length
    assert finalize.attrs == {"decoded_frames": finalize.attrs["decoded_frames"],
                              "kept_frames": sum(len(res.wave) // hop for res in results)}
    assert len(budgets) == 1 and budgets[0] % pipeline.FRAME_BUCKET == 0
    assert finalize.attrs["decoded_frames"] == 2 * budgets[0]
    assert all(r.attrs == {} for r in records if r is not finalize)


def test_a_stream_records_its_chunks_under_one_trace_and_none_across_a_yield(synth):
    profiling.clear()
    yielded = []
    with profiling.recording():
        for res in synth.stream(STREAM_TEXT):
            yielded.append(time.perf_counter_ns())
            time.sleep(0.002)  # the caller holds the chunk; no span may be open
    records = profiling.spans()
    assert len(yielded) >= 3
    assert len({r.trace for r in records}) == 1
    roots = sorted((r for r in records if r.parent is None), key=lambda r: r.start)
    assert [r.name for r in roots] == ["synth.chunk"] * len(yielded)
    assert [r.attrs["chunk"] for r in roots] == list(range(len(yielded)))
    for r in records:
        assert not any(r.start < t < r.end for t in yielded), r.name
    by_root = {root.id: [r.name for r in records if r.parent == root.id] for root in roots}
    assert by_root[roots[0].id] == ["synth.tokens", "synth.lead"]
    lead = next(r for r in records if r.name == "synth.lead")
    assert [r.name for r in records if r.parent == lead.id] == ["lead.program", "synth.finalize"]
    assert lead.attrs == {}
    # the first bucketed chunk predicts the durations of all; each later one
    # dispatches the next chunk before it fetches its own
    assert "synth.durations" in by_root[roots[1].id]
    for root in roots[1:]:
        assert by_root[root.id].count("synth.finalize") == 1
    assert sum(by_root[root.id].count("synth.dispatch") for root in roots) == len(roots) - 1


def test_a_profiler_session_records_spans_and_holds_none_of_them(synth):
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        synth.synthesize_batch(TEXTS)
    names = {r.name for r in _per_request(profiling.spans())}
    assert {"synth.batch", "synth.durations", "synth.decode", "synth.vocode", "synth.finalize"} <= names
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not names & events
    assert not any(e.startswith(("synth.", "lead.", "server.", "batcher.")) for e in events)


def test_a_span_covers_its_op_on_the_profilers_clock():
    """Mapped through a (time_ns, perf_counter) anchor, as the benchmark maps
    a span onto the device trace, a span covers the op run inside it."""
    profiling.clear()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchor = (time.time_ns(), time.perf_counter())
        with profiling.span("probe", "issue"):
            time.sleep(0.005)
            x.mul_(2.0)
            time.sleep(0.005)
    rec = next(r for r in profiling.spans() if r.name == "probe")
    op = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul_"]
    assert len(op) == 1
    ns0, pc0 = anchor
    start, end = (ns0 + t - round(pc0 * 1e9) for t in (rec.start, rec.end))
    slack = 1_000_000  # 1 ms: the op sits 5 ms from either edge
    assert start - slack <= op[0].start_ns() and op[0].start_ns() + op[0].duration_ns() <= end + slack
    assert op[0].start_ns() - start > 5_000_000 - slack and end - op[0].start_ns() > 5_000_000 - slack


def test_set_up_records_its_parts(synth, monkeypatch):
    import dataclasses

    assert "capture_s" not in {f.name for f in dataclasses.fields(pipeline.LeadGraph)}
    assert not hasattr(_build, "build_seconds")
    profiling.clear()
    s = pipeline.Synthesizer(synth.cfg, device="cpu")
    s.warmup(token_buckets=(32,), frame_buckets=(128,))
    records = profiling.spans()
    top = [r for r in records if r.name == "setup.synthesizer"]
    assert len(top) == 1
    children = sorted((r for r in records if r.parent == top[0].id), key=lambda r: r.start)
    assert [(r.name, r.attrs.get("kind")) for r in children] == [
        ("setup.checkpoint", "duration"), ("setup.checkpoint", "acoustic"), ("setup.checkpoint", "hifigan"),
        ("setup.models", None)]
    warm = [r for r in records if r.name == "setup.warmup"]
    assert len(warm) == 1 and warm[0].parent is None and warm[0].start >= top[0].end
    assert _per_request(records) == []  # warm-up's stages record only when recording

    # the kernel library's build or load: the plan library, which builds on
    # the CPU too, stands in for it (it needs nvcc)
    plan = _build.load_plan_library()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "SIGNATURES", {})
    monkeypatch.setattr(_build, "library_path", lambda: Path(plan._name))
    _build.load_library()
    libs = [r for r in profiling.spans() if r.name == "setup.library"]
    assert len(libs) == 1 and libs[0].attrs == {"built": False} and libs[0].parent is None


def test_the_server_records_its_lock_and_its_batches(synth):
    """A stream through the server: one root a chunk over the lock's wait
    and the stream's own spans; a batch of the batcher: its own root, on
    the worker's thread, under its own trace."""
    server = serve.TTSServer(synth, host="127.0.0.1", port=0, batch_window_ms=1.0)
    try:
        profiling.clear()
        with profiling.recording():
            chunks = list(server.stream_results(STREAM_TEXT))
            wave = server.batcher.submit(TEXTS[0])
        records = profiling.spans()
    finally:
        server.httpd.server_close()
        server.batcher.close()
    assert len(wave) > 0
    stream = [r for r in records if r.name == "server.chunk"]
    # one root a chunk, and the step that finds the stream ended
    assert [r.attrs["chunk"] for r in sorted(stream, key=lambda r: r.start)] == list(range(len(chunks) + 1))
    assert all(r.parent is None for r in stream) and len({r.trace for r in stream}) == 1
    locks = [r for r in records if r.name == "server.lock"]
    assert len(locks) == len(stream) and all(r.kind == "queue" for r in locks)
    assert {r.parent for r in locks} == {r.id for r in stream}
    inner = [r for r in records if r.name == "synth.chunk"]
    assert len(inner) == len(chunks) and {r.trace for r in inner} == {stream[0].trace}
    assert not any(r.name.startswith("batcher.") for r in records)
    batch = [r for r in records if r.name == "synth.batch"]
    assert len(batch) == 1 and batch[0].parent is None and batch[0].thread != stream[0].thread
    assert batch[0].trace != stream[0].trace
    assert {r.trace for r in records if r.thread == batch[0].thread} == {batch[0].trace}


def test_threads_record_side_by_side():
    """Many threads at a short switch interval: every span is kept once,
    nested under its own thread's parent."""
    threads_n, spans_n = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.clear()

    def work():
        for _ in range(spans_n):
            with profiling.span("outer", "host"):
                with profiling.span("inner", "issue"):
                    pass

    try:
        with profiling.recording():
            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    records = profiling.spans()
    assert len(records) == 2 * threads_n * spans_n
    assert len({r.id for r in records}) == len(records)
    outer = {r.id: r for r in records if r.name == "outer"}
    for r in records:
        if r.name == "inner":
            p = outer[r.parent]
            assert p.thread == r.thread and p.trace == r.trace
    assert len({r.trace for r in outer.values()}) == threads_n * spans_n
    profiling.clear()


def test_an_unknown_kind_is_refused():
    with profiling.recording(), pytest.raises(ValueError, match="kind"):
        profiling.span("x", "idle")
