"""HTTP serving of the PyTorch port (counterpart of ``viettts_tpu/serve.py``).

``viettts_tpu.serve``'s ``DynamicBatcher`` (request coalescing on one
worker thread) and ``TTSServer`` (stdlib HTTP front end) import only the
standard library and numpy, so the port reuses them, as ``config.py``
reuses ``viettts_tpu.config``, around the port's ``Synthesizer``:

    POST /tts         {"text": "...", "silence_duration": -1.0} -> WAV bytes
    POST /tts/stream  same payload -> chunked 16-bit PCM, one chunk per
                      ``Synthesizer.stream`` chunk (X-Sample-Rate header)
    GET  /healthz     -> {"status": "ok"}
    GET  /stats       -> request/batch counters, latency percentiles and, on
                      the calibrated int8 route, int8_max_clip_fraction

One fault of the reference is fixed here: its sampled int8 clip probe
fires on the very first batch (``n_batches % every == 0`` at
``n_batches == 0``); the port's fires on every ``every``-th batch,
counting from 1.

Usage::

    python -m viettts_tpu_torch.serve --port 8080 --ckpt-dir assets/infore/nat \\
        --lexicon-file assets/infore/lexicon.txt --warmup \\
        --set hifigan.inference_dtype=int8

There is no device fallback: ``--device cuda`` (the default) fails when no
GPU is available.  One process serves one device.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from viettts_tpu import serve as _reference


class DynamicBatcher(_reference.DynamicBatcher):
    """The reference batcher with the int8 clip probe due on batches
    ``every``, ``2 * every``, ... (never the first, unless ``every`` is 1)."""

    def _maybe_clip_probe(self, results) -> None:
        """Sampled int8 clip-rate probe on a just-served mel.  Called under
        ``synth_lock``, before this batch is counted; a failure of the
        diagnostic never fails the batch."""
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


class TTSServer(_reference.TTSServer):
    """The reference HTTP front end over the port's ``DynamicBatcher``."""

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
        super().__init__(
            synthesizer, host=host, port=port, max_batch=max_batch,
            batch_window_ms=batch_window_ms, max_pending=max_pending, clip_probe_every=0,
        )
        # The reference constructor builds its own batcher, which has not
        # served anything yet: stop it and serve through the port's.
        self.batcher.close()
        self.batcher = DynamicBatcher(
            synthesizer, max_batch=max_batch, batch_window_ms=batch_window_ms,
            max_pending=max_pending, clip_probe_every=clip_probe_every,
        )


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
    p.add_argument("--warmup", action="store_true",
                   help="calibrate the int8 route and run every token bucket "
                        "once before listening")
    p.add_argument("--int8-probe-every", type=int, default=200,
                   help="every N batches, probe one served mel for the int8 "
                        "clip rate (0 disables); see /stats int8_max_clip_fraction")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="config override, e.g. --set hifigan.inference_dtype=int8")
    args = p.parse_args(argv)

    cfg = apply_overrides(Config(), args.set)
    if args.ckpt_dir:
        cfg = cfg.replace(ckpt_dir=args.ckpt_dir)
    synth = Synthesizer(cfg, lexicon_file=args.lexicon_file, device=args.device)
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
