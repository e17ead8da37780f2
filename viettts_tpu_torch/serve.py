"""HTTP serving of the PyTorch port (counterpart of ``viettts_tpu/serve.py``,
with its own copy of the batcher and front end).

Two layers, separable for testing and embedding:

* ``DynamicBatcher``: producer threads submit texts and block on a
  per-request future; one worker thread drains the queue (up to
  ``max_batch``, waiting ``batch_window_ms`` after the first request for
  stragglers) and runs ``Synthesizer.synthesize_batch``, so all device
  work stays on that thread.
* ``TTSServer``: a stdlib ThreadingHTTPServer front end:

    POST /tts         {"text": "...", "silence_duration": -1.0} -> WAV bytes
    POST /tts/stream  same payload -> chunked 16-bit PCM, one chunk per
                      ``Synthesizer.stream`` chunk (X-Sample-Rate header)
    GET  /healthz     -> {"status": "ok"}
    GET  /stats       -> request/batch counters, latency percentiles and, on
                      the calibrated int8 route, int8_max_clip_fraction

A batch of one short text and a stream's chunk 0 take the Synthesizer's
single-dispatch lead program: on CUDA one graph replay per request,
captured by ``--warmup`` (or at a token bucket's first use, inside the
first request that reaches it).

One fault of the reference is not copied: its sampled int8 clip probe
fires on the very first batch (``n_batches % every == 0`` at
``n_batches == 0``); the port's fires on every ``every``-th batch,
counting from 1.

Usage::

    python -m viettts_tpu_torch.serve --port 8080 --ckpt-dir assets/infore/nat \\
        --lexicon-file assets/infore/lexicon.txt --warmup \\
        --set hifigan.inference_dtype=int8

There is no device fallback: ``--device cuda`` (the default) fails when no
GPU is available.  ``--num-devices N`` serves every batch sharded over
``cuda:0`` .. ``cuda:N-1``, one replica each (``Synthesizer(devices=...)``);
it refuses N above ``torch.cuda.device_count()`` rather than serve on
fewer.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np

from viettts_tpu_torch.audio import pcm16, wav_bytes
from viettts_tpu_torch.utils.profiling import new_trace, span


class QueueFullError(RuntimeError):
    """Raised by ``DynamicBatcher.submit`` when the pending queue is at
    ``max_pending``.  ``retry_after_s`` is a conservative estimate of when
    capacity frees up (the HTTP layer forwards it as ``Retry-After``)."""

    def __init__(self, pending: int, retry_after_s: int):
        super().__init__(
            f"queue full ({pending} pending); retry in {retry_after_s}s"
        )
        self.pending = pending
        self.retry_after_s = retry_after_s


@dataclass
class _Request:
    text: str
    silence_duration: float
    done: threading.Event = field(default_factory=threading.Event)
    wave: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    t_enqueue: float = field(default_factory=time.perf_counter)
    # set by a timed-out submit(): the worker skips the request instead of
    # synthesizing audio nobody will read (and excludes it from stats)
    cancelled: bool = False


class DynamicBatcher:
    """Coalesce concurrent synthesis requests into batched device calls.

    ``submit`` blocks until the request's batch has been synthesized and
    returns the waveform.  The worker drains whole batches: it takes the
    first pending request, then waits up to ``batch_window_ms`` for more
    (up to ``max_batch``); requests with differing ``silence_duration``
    are grouped into sub-batches since the pipeline applies one clamp
    value per call.
    """

    def __init__(
        self,
        synthesizer,
        max_batch: int = 16,
        batch_window_ms: float = 20.0,
        max_pending: int = 128,
        clip_probe_every: int = 200,
    ):
        self._synth = synthesizer
        self.max_batch = int(max_batch)
        self.batch_window_ms = float(batch_window_ms)
        # int8 out-of-range observability: every N batches, one served mel
        # is re-run through the f32 clip-stat probe (costs ~one vocoder
        # forward) so silent hard-clipping on the static-int8 route shows
        # up in /stats instead of only in the audio.  0 disables.
        self.clip_probe_every = int(clip_probe_every)
        # admission control: beyond this many queued-but-unstarted requests
        # submit() refuses with QueueFullError instead of growing the queue
        # without bound under overload (each pending request pins its text
        # and eventually a waveform in memory)
        self.max_pending = int(max_pending)
        self._queue: deque[_Request] = deque()
        self._lock = threading.Lock()
        # serializes device dispatch between the batch worker and any
        # streaming request threads (one chunk / one batch at a time)
        self.synth_lock = threading.Lock()
        self._wakeup = threading.Event()
        self._shutdown = False
        # stats
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_rejected = 0
        self.batch_sizes: deque = deque(maxlen=1000)
        self.latencies_ms: deque = deque(maxlen=1000)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- producer side ---------------------------------------------------

    def submit(
        self, text: str, silence_duration: float = -1.0, timeout: float = 300.0
    ) -> np.ndarray:
        req = _Request(text=text, silence_duration=float(silence_duration))
        with self._lock:
            if self._shutdown:
                raise RuntimeError("batcher is shut down")
            pending = len(self._queue)
            if pending >= self.max_pending:
                retry = self._retry_after_estimate(pending)
                with self._stats_lock:
                    self.n_rejected += 1
                raise QueueFullError(pending, retry)
            self._queue.append(req)
        self._wakeup.set()
        if not req.done.wait(timeout):
            req.cancelled = True
            raise TimeoutError("synthesis timed out")
        if req.error is not None:
            raise req.error
        with self._stats_lock:
            self.latencies_ms.append(
                (time.perf_counter() - req.t_enqueue) * 1e3
            )
        return req.wave

    def close(self):
        with self._lock:
            self._shutdown = True
        self._wakeup.set()
        self._worker.join(timeout=5)

    def _retry_after_estimate(self, pending: int) -> int:
        """Seconds until the queue has likely drained below ``max_pending``.

        Uses the observed p50 request latency (which includes queueing) as
        a per-batch cost proxy; with no history yet, assumes 1 s/batch.
        Conservative by design — clients honoring ``Retry-After`` should
        not immediately bounce off the full queue again.
        """
        with self._stats_lock:
            lats = sorted(self.latencies_ms)
            batch_s = (lats[len(lats) // 2] / 1e3) if lats else 1.0
        batches_ahead = max(1, -(-pending // self.max_batch))  # ceil div
        return max(1, int(np.ceil(batches_ahead * batch_s)))

    # -- worker side -----------------------------------------------------

    def _drain(self) -> List[_Request]:
        """Take the next batch: first request + stragglers within the
        batching window, up to max_batch."""
        with self._lock:
            if not self._queue:
                return []
            batch = [self._queue.popleft()]
        deadline = time.perf_counter() + self.batch_window_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            with self._lock:
                while self._queue and len(batch) < self.max_batch:
                    batch.append(self._queue.popleft())
            if len(batch) >= self.max_batch or remaining <= 0:
                break
            time.sleep(min(remaining, 0.002))
        return batch

    def _run(self):
        while True:
            self._wakeup.wait()
            with self._lock:
                if self._shutdown and not self._queue:
                    return
                if not self._queue:
                    self._wakeup.clear()
                    continue
            batch = self._drain()
            if not batch:
                continue
            # group by silence_duration (one clamp value per device call);
            # timed-out (cancelled) requests are dropped here — their
            # caller already got an error, so synthesizing them would
            # waste a batch slot
            groups: dict = {}
            for r in batch:
                if r.cancelled:
                    r.done.set()
                    continue
                groups.setdefault(r.silence_duration, []).append(r)
            for sd, reqs in groups.items():
                try:
                    with self.synth_lock:
                        results = self._synth.synthesize_batch(
                            [r.text for r in reqs], silence_duration=sd
                        )
                        self._maybe_clip_probe(results)
                    for r, res in zip(reqs, results):
                        r.wave = np.asarray(res.wave)
                except Exception as e:  # pragma: no cover - defensive
                    for r in reqs:
                        r.error = e
                finally:
                    for r in reqs:
                        r.done.set()
                with self._stats_lock:
                    self.n_requests += len(reqs)
                    self.n_batches += 1
                    self.batch_sizes.append(len(reqs))

    def _maybe_clip_probe(self, results) -> None:
        """Sampled int8 clip-rate probe on a just-served mel, due on batches
        ``every``, ``2 * every``, ... counted from 1 (never the first,
        unless ``every`` is 1).  Called under ``synth_lock``, before this
        batch is counted; a failure of the diagnostic never fails the
        batch."""
        if not self.clip_probe_every or not results:
            return
        with self._stats_lock:
            due = (self.n_batches + 1) % self.clip_probe_every == 0
        if not due or getattr(self._synth, "_act_scales", None) is None:
            return
        try:
            self._synth.int8_clip_stats(mel=results[0].mel)
        except Exception:  # diagnostic only: log it, keep serving
            logging.getLogger(__name__).exception("int8 clip probe failed")

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            sizes = list(self.batch_sizes)
            lats = sorted(self.latencies_ms)
            d = {
                "requests": self.n_requests,
                "batches": self.n_batches,
                "rejected": self.n_rejected,
                "mean_batch_size": float(np.mean(sizes)) if sizes else 0.0,
                "pending": len(self._queue),
                "max_pending": self.max_pending,
            }
            if lats:
                d["latency_ms_p50"] = lats[len(lats) // 2]
                d["latency_ms_p95"] = lats[int(len(lats) * 0.95)]
        clip = getattr(self._synth, "last_clip_stats", None)
        if clip is not None:
            d["int8_max_clip_fraction"] = clip["max_clip_fraction"]
        return d


class TTSServer:
    """HTTP front end over a DynamicBatcher."""

    def __init__(
        self,
        synthesizer,
        host: str = "0.0.0.0",
        port: int = 8080,
        max_batch: int = 16,
        batch_window_ms: float = 20.0,
        max_pending: int = 128,
        clip_probe_every: int = 200,
    ):
        self.sample_rate = synthesizer.cfg.dsp.sample_rate
        self._synth = synthesizer
        self.batcher = DynamicBatcher(
            synthesizer,
            max_batch=max_batch,
            batch_window_ms=batch_window_ms,
            max_pending=max_pending,
            clip_probe_every=clip_probe_every,
        )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 for chunked transfer on the streaming endpoint
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._json(200, outer.batcher.stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/tts", "/tts/stream"):
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    text = payload["text"]
                    sd = float(payload.get("silence_duration", -1.0))
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": f"bad request: {e}"})
                    return
                if self.path == "/tts/stream":
                    self._stream_pcm(text, sd)
                    return
                try:
                    wav = outer.batcher.submit(text, sd)
                except QueueFullError as e:
                    # overload: shed the request instead of queueing it
                    body = json.dumps(
                        {"error": str(e), "pending": e.pending}
                    ).encode()
                    self.send_response(429)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Retry-After", str(e.retry_after_s))
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                except Exception as e:
                    self._json(500, {"error": str(e)})
                    return
                body = wav_bytes(wav, outer.sample_rate)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream_pcm(self, text: str, sd: float):
                """Chunked-transfer streaming: one 16-bit little-endian
                mono PCM chunk per synthesized text chunk, produced by
                ``Synthesizer.stream`` (chunk i+1 decodes on-device while
                chunk i is on the wire).  Time-to-first-audio is one
                chunk's latency instead of the whole utterance's."""
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-Sample-Rate", str(outer.sample_rate))
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for res in outer.stream_results(text, sd):
                        pcm = pcm16(res.wave).tobytes()
                        if pcm:
                            self.wfile.write(
                                f"{len(pcm):X}\r\n".encode() + pcm + b"\r\n"
                            )
                except Exception:
                    # Drop the connection WITHOUT the terminating chunk:
                    # a mid-stream synthesis failure must surface to the
                    # client as a truncated chunked body, not as a clean,
                    # silently-shortened audio response.
                    self.close_connection = True
                    return
                self.wfile.write(b"0\r\n\r\n")

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    def stream_results(self, text: str, silence_duration: float = -1.0):
        """Iterate ``Synthesizer.stream`` with the device serialized
        against the batch worker: the lock is held per chunk, so batched
        requests interleave between a long stream's chunks instead of
        starving behind it.  Each chunk is a root span, ``server.chunk``
        (attr ``chunk``), all of a stream's under one trace id, with the
        wait for the lock (``server.lock``) and the stream's own spans
        inside."""
        it = self._synth.stream(text, silence_duration=silence_duration)
        trace = new_trace()
        k = 0
        while True:
            with span("server.chunk", "host", trace, chunk=k):
                with span("server.lock", "queue"):
                    self.batcher.synth_lock.acquire()
                try:
                    res = next(it)
                except StopIteration:
                    return
                finally:
                    self.batcher.synth_lock.release()
            yield res
            k += 1

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()



def serving_devices(device: str, num_devices: int) -> dict:
    """``--device`` and ``--num-devices`` as ``Synthesizer``'s ``device=``
    (one device) or ``devices=`` (``cuda:0`` .. ``cuda:N-1``)."""
    import torch

    if num_devices < 1:
        raise ValueError(f"--num-devices {num_devices}: at least 1")
    if num_devices == 1:
        return {"device": device}
    if torch.device(device) != torch.device("cuda"):
        raise ValueError(f"--num-devices {num_devices} serves on cuda:0 .. cuda:{num_devices - 1}; "
                         f"--device {device} is for one device")
    visible = torch.cuda.device_count()
    if num_devices > visible:
        raise ValueError(f"--num-devices {num_devices}: only {visible} CUDA devices are visible; "
                         "refusing to serve on fewer")
    return {"devices": [f"cuda:{i}" for i in range(num_devices)]}


def build_server(argv: Optional[Sequence[str]] = None) -> TTSServer:
    """Parse the command line, load (and with ``--warmup`` warm) the port's
    Synthesizer, and bind the server; ``main`` then serves it."""
    from argparse import ArgumentParser
    from pathlib import Path

    from viettts_tpu_torch.config import Config, apply_overrides
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    p = ArgumentParser(description="viettts_tpu_torch dynamic-batching TTS server")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--ckpt-dir", type=Path, default=None)
    p.add_argument("--lexicon-file", type=Path, default=None)
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--batch-window-ms", type=float, default=20.0)
    p.add_argument("--max-pending", type=int, default=128,
                   help="refuse (HTTP 429) requests beyond this many queued")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda; no CPU fallback)")
    p.add_argument("--num-devices", type=int, default=1,
                   help="shard each batch over cuda:0 .. cuda:N-1, one replica each")
    p.add_argument("--warmup", action="store_true",
                   help="calibrate the int8 route, run every token bucket once "
                        "and capture the lead program's graphs before listening")
    p.add_argument("--int8-probe-every", type=int, default=200,
                   help="every N batches, probe one served mel for the int8 "
                        "clip rate (0 disables); see /stats int8_max_clip_fraction")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="config override, e.g. --set hifigan.inference_dtype=int8")
    args = p.parse_args(argv)

    cfg = apply_overrides(Config(), args.set)
    if args.ckpt_dir:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)
    synth = Synthesizer(cfg, lexicon_file=args.lexicon_file, **serving_devices(args.device, args.num_devices))
    if args.warmup:
        synth.warmup()
    return TTSServer(
        synth, host=args.host, port=args.port, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, max_pending=args.max_pending,
        clip_probe_every=args.int8_probe_every,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    server = build_server(argv)
    host, port = server.httpd.server_address[:2]
    print(f"serving on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
