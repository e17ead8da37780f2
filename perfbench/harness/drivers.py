"""The two ways a traffic file drives the program, named by its
``driver`` key:

* ``closed_batch``: one caller, back-to-back ``Synthesizer.synthesize_batch``
  of ``batch`` texts (bulk voicing);
* ``closed_stream``: one listener, back-to-back paragraphs iterated as the
  server's ``TTSServer.stream_results`` iterates ``Synthesizer.stream``,
  chunk by chunk under the batcher's lock; the server is built on
  127.0.0.1, port 0, and never serves.

Each records, in the order the program ran them, every dispatch it caused
(what the reference replays to work out padding and frame budgets) and the
outputs of a sample of requests drawn from the seed (with the longest),
copied as the caller received them; the rest is dropped at once.  Times are
the host clock's (``time.perf_counter``)."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
from torch.profiler import record_function

from perfbench.harness import texts as tx


@dataclasses.dataclass
class Output:
    """What a sampled request or chunk returned, copied."""

    wave: np.ndarray
    mel: np.ndarray
    durations: np.ndarray


@dataclasses.dataclass
class Dispatch:
    """One call into the program: a batch call (``texts``) or a stream
    (``text``, one entry of ``durations`` a chunk)."""

    kind: str  # "batch" | "stream"
    texts: List[str]
    durations: List[np.ndarray]  # each row's (chunk's) durations as returned
    kept: List[int]  # each row's (chunk's) samples as returned
    sampled: Dict[int, Output]  # row (chunk) index -> its outputs
    t0: float
    t1: float


def chosen(seed: int, index: int, q: float) -> bool:
    """Whether request ``index`` of a run of ``seed`` is in the sample."""
    return bool(np.random.default_rng([int(seed) % 2 ** 63, index, 7]).random() < q)


def _copy(res) -> Output:
    return Output(np.array(res.wave, np.float32), np.array(res.mel, np.float32), np.array(res.durations, np.float32))


class Record:
    """A run's dispatches and per-request timings."""

    def __init__(self):
        self.dispatches: List[Dispatch] = []
        self.window = (0.0, 0.0)  # host clock: start, end of the measured window
        self.attempted = 0
        self.failed = 0
        self.first_audio_ms: List[float] = []
        self.audio_samples = 0


# ---------------------------------------------------------------------------


def closed_batch(synth, traffic: dict, seed: int, seconds: float, rng, tracer, record: Record) -> None:
    vocab = tx.words()
    t = traffic["tokens"]
    grid = tx.size_grid(traffic["batch"], t["median"], t["sigma"], t["min"], t["max"])
    calls = [[tx.sentence(rng, n, vocab) for n in tx.shuffled(rng, grid)] for _ in range(traffic["prepared_calls"])]
    q = traffic["sample_calls"]
    last: Optional[Dispatch] = None
    start = time.perf_counter()
    record.window = (start, start)
    i = 0
    while time.perf_counter() - start < seconds:
        batch = calls[i % len(calls)]
        tracer.before(time.perf_counter())
        t0 = time.perf_counter()
        with record_function("perfbench.synthesize_batch"):
            results = synth.synthesize_batch(batch)
        t1 = time.perf_counter()
        d = Dispatch("batch", batch, [np.array(r.durations, np.float32) for r in results],
                     [len(r.wave) for r in results], {}, t0, t1)
        # every call's longest row and one drawn row are copied; a call keeps
        # them if it is drawn, or while it is the last
        rows = {int(np.argmax([len(x) for x in d.durations])),
                int(np.random.default_rng([int(seed) % 2 ** 63, i, 11]).integers(len(results)))}
        d.sampled = {r: _copy(results[r]) for r in rows}
        if last is not None and not chosen(seed, i - 1, q):
            last.sampled = {}
        last = d
        record.dispatches.append(d)
        record.attempted += len(batch)
        record.failed += len(batch) - len(results)
        record.audio_samples += sum(len(r.wave) for r in results)
        del results
        i += 1
    record.window = (start, time.perf_counter())


# ---------------------------------------------------------------------------


def closed_stream(synth, traffic: dict, seed: int, seconds: float, rng, tracer, record: Record) -> None:
    from viettts_tpu_torch.serve import TTSServer

    vocab = tx.words()
    t = traffic["tokens"]
    sizes = tx.size_grid(t["pool"], t["median"], t["sigma"], t["min"], t["max"])
    counts = traffic["sentences"]
    paragraphs, pool = [], []
    for _ in range(traffic["prepared_streams"]):
        k = counts[len(paragraphs) % len(counts)]
        while len(pool) < k:
            pool += tx.shuffled(rng, sizes)
        paragraphs.append(" ".join(tx.sentence(rng, pool.pop(), vocab) for _ in range(k)))
    paragraphs = tx.shuffled(rng, paragraphs)
    if int(traffic["lead_tokens"]) != 64:
        raise ValueError("the server streams with Synthesizer.stream's default lead chunk, 64 tokens")
    server = TTSServer(synth, host="127.0.0.1", port=0, max_batch=traffic["max_batch"],
                       batch_window_ms=traffic["batch_window_ms"], max_pending=traffic["max_pending"])
    q = traffic["sample_streams"]
    longest = max(range(len(paragraphs)), key=lambda i: len(paragraphs[i]))
    try:
        start = time.perf_counter()
        record.window = (start, start)
        i = 0
        last: Optional[Dispatch] = None
        while time.perf_counter() - start < seconds:
            text = paragraphs[i % len(paragraphs)]
            tracer.before(time.perf_counter())
            d = Dispatch("stream", [text], [], [], {}, time.perf_counter(), 0.0)
            first = None
            for k, res in enumerate(server.stream_results(text)):
                if first is None:
                    first = time.perf_counter() - d.t0
                d.durations.append(np.array(res.durations, np.float32))
                d.kept.append(len(res.wave))
                d.sampled[k] = _copy(res)
            d.t1 = time.perf_counter()
            # a stream keeps its chunks if it is drawn or the longest, or while it is the last
            if last is not None and not last_keep:
                last.sampled = {}
            last, last_keep = d, chosen(seed, i, q) or i % len(paragraphs) == longest
            record.dispatches.append(d)
            record.first_audio_ms.append(1e3 * first)
            record.attempted += 1
            record.audio_samples += sum(d.kept)
            i += 1
        record.window = (start, time.perf_counter())
    finally:
        server.httpd.server_close()
        server.batcher.close()


DRIVERS = {"closed_batch": closed_batch, "closed_stream": closed_stream}
