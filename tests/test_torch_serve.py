"""The port's HTTP server (``viettts_tpu_torch.serve``: its own batcher and
front end) on the CPU, over the int8 route of a tiny seeded Synthesizer,
its clip-probe schedule and its queue limit."""

import io
import json
import threading
import time
import urllib.request
import wave
from dataclasses import dataclass

import numpy as np
import pytest

from viettts_tpu_torch import serve
from viettts_tpu_torch.infer.pipeline import Synthesizer
from tests.test_torch_pipeline import _cfg, _int8, _write_checkpoints, port_config


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_serve_ckpts"))
    s = Synthesizer(port_config(_int8(_cfg(d))), device="cpu")
    s.calibrate_int8(texts=("một hai ba",))
    return s


def _post(base, path, text):
    req = urllib.request.Request(
        base + path, data=json.dumps({"text": text}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.headers, r.read()


def _stats(base, batches):
    """/stats once the worker has counted ``batches`` batches (it counts a
    batch just after answering its requests)."""
    deadline = time.monotonic() + 30
    while True:
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        if stats["batches"] >= batches or time.monotonic() > deadline:
            return stats
        time.sleep(0.01)


def test_http_server_int8_route(synth):
    """/tts twice and /tts/stream once on the calibrated int8 route, with
    the clip probe due every 2 batches: nothing is probed on the first
    batch, the second reports int8_max_clip_fraction on /stats, and the
    streamed PCM has as many samples as the one-shot wav."""
    synth.last_clip_stats = None
    server = serve.TTSServer(synth, host="127.0.0.1", port=0, batch_window_ms=5.0, clip_probe_every=2)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        headers, blob = _post(base, "/tts", "một hai ba")
        assert headers["Content-Type"] == "audio/wav"
        with wave.open(io.BytesIO(blob)) as w:
            assert w.getframerate() == synth.cfg.dsp.sample_rate
            n_samples = w.getnframes()
        assert n_samples > 0
        first = _stats(base, 1)
        assert first["batches"] == 1 and "int8_max_clip_fraction" not in first
        assert synth.last_clip_stats is None

        _post(base, "/tts", "bốn năm sáu")
        second = _stats(base, 2)
        assert second["batches"] == 2
        assert 0.0 <= second["int8_max_clip_fraction"] <= 1.0
        assert synth.last_clip_stats is not None

        headers, pcm = _post(base, "/tts/stream", "một hai ba")
        assert headers["X-Sample-Rate"] == str(synth.cfg.dsp.sample_rate)
        assert len(pcm) == 2 * n_samples
    finally:
        server.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


@dataclass
class _Result:
    wave: np.ndarray
    mel: np.ndarray


class _ProbedSynth:
    """Counts clip probes; every batch is one row of silence."""

    _act_scales = {0: None}

    def __init__(self):
        self.probes = 0

    def synthesize_batch(self, texts, silence_duration=-1.0):
        return [_Result(np.zeros(16, np.float32), np.zeros((1, 80), np.float32)) for _ in texts]

    def int8_clip_stats(self, mel=None):
        self.probes += 1
        self.last_clip_stats = {"max_clip_fraction": 0.0}


@pytest.mark.parametrize("every,batches,probes", [(3, 2, 0), (3, 3, 1), (2, 5, 2), (1, 1, 1), (0, 4, 0)])
def test_clip_probe_fires_on_every_nth_batch(every, batches, probes):
    """The probe is due on batches every, 2*every, ... counted from 1; the
    reference's ``n_batches % every`` also fires on the very first batch."""
    fake = _ProbedSynth()
    batcher = serve.DynamicBatcher(fake, batch_window_ms=0.0, clip_probe_every=every)
    try:
        for i in range(batches):
            batcher.submit(f"t{i}", timeout=30)
    finally:
        batcher.close()
    assert batcher.stats()["batches"] == batches
    assert fake.probes == probes


class _BlockingSynth:
    """synthesize_batch blocks until released; ``started`` is set once the
    worker is inside it."""

    def __init__(self):
        self.started, self.release = threading.Event(), threading.Event()

    def synthesize_batch(self, texts, silence_duration=-1.0):
        self.started.set()
        self.release.wait(30)
        return [_Result(np.zeros(16, np.float32), np.zeros((1, 80), np.float32)) for _ in texts]


def test_queue_full_refuses_with_retry_after():
    """With one request in synthesis and ``max_pending`` queued, submit
    refuses with QueueFullError (HTTP 429 upstream) and counts it; the
    queued requests are still served."""
    fake = _BlockingSynth()
    batcher = serve.DynamicBatcher(fake, max_batch=1, batch_window_ms=0.0, max_pending=1, clip_probe_every=0)
    done = []
    workers = [threading.Thread(target=lambda i=i: done.append(batcher.submit(f"t{i}", timeout=30))) for i in range(2)]
    try:
        workers[0].start()
        assert fake.started.wait(30)
        workers[1].start()
        deadline = time.monotonic() + 30
        while batcher.stats()["pending"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(serve.QueueFullError) as err:
            batcher.submit("refused", timeout=30)
        assert err.value.pending == 1 and err.value.retry_after_s >= 1
        assert batcher.stats()["rejected"] == 1
    finally:
        fake.release.set()
        for w in workers:
            w.join(timeout=30)
        batcher.close()
    assert len(done) == 2 and batcher.stats()["requests"] == 2
