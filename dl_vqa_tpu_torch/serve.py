"""Serving daemon of the port: HTTP batch inference on a trained checkpoint.

The port's copy of the root ``serve.py``, on :class:`dl_vqa_tpu_torch.
predict.Predictor`:

    python -m dl_vqa_tpu_torch.serve [overrides...] --port 8000

    POST /v1/answer   {"image_b64": <base64 image>, "question": str,
                       "top_k": int=5}            -> {"answers": [[a, p]..]}
    GET  /healthz     liveness, the predictor's device type and name
    GET  /metrics     JSON counters: requests, batches, batch-size mean,
                      errors/timeouts/rejected, latency p50/p99 ms

* **Request coalescing.** Handler threads enqueue requests; one batcher
  thread drains the queue, waits up to ``--batch-window-ms`` for
  stragglers, and runs ONE forward per batch, under
  ``torch.inference_mode()``.
* **Bucketed shapes.** Batches pad up to the next power of two, clamped to
  ``--max-batch``, so the card sees at most log2(max_batch)+2 shapes;
  :meth:`BatchingService.warmup` pays each one's first launch and cuDNN's
  choice of algorithm before traffic does.
* Host work (image decode, resize, tokenize) happens on the handler
  threads, off the batcher's path. Images are decoded to uint8 by the
  exact decoder (:mod:`dl_vqa_tpu_torch.data.images`: PIL's pixels of a
  JPEG, PNG or BMP, the entropy decoding on the host and its last stages
  on the model's card, on a stream of the handler's own), go to the card
  as uint8 and are normalised there. What the decoder does not take gets
  415; the native front takes JPEG only, as the JAX package's does.

``--native-front`` serves through the C++ front of ``native/serve_front.cc``
(:mod:`dl_vqa_tpu_torch.utils.native_front`). The model runs on the GPU
unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import statistics
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from dl_vqa_tpu_torch.data.images import UnsupportedImage
from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["BatchingService", "ServiceOverloaded", "make_handler",
           "build_server", "build_native_server", "main"]


class _Pending:
    __slots__ = ("image", "encoded", "length", "top_k", "event", "result",
                 "error", "enqueued_at", "abandoned")

    def __init__(self, image, encoded, length, top_k):
        self.image = image
        self.encoded = encoded
        self.length = length
        self.top_k = top_k
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        self.enqueued_at = time.perf_counter()
        # Set by submit() on timeout: the handler is gone, so the batcher
        # drops the entry instead of running a forward nobody reads.
        self.abandoned = False


class ServiceOverloaded(RuntimeError):
    """Raised by :meth:`BatchingService.submit` when the bounded request
    queue is full: mapped to HTTP 503 so that clients back off."""


class BatchingService:
    """Coalesces concurrent requests into bucketed forwards."""

    def __init__(self, predictor, max_batch: int = 64,
                 batch_window_ms: float = 5.0,
                 request_timeout_s: float = 300.0,
                 max_queue: int = 0):
        self.predictor = predictor
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        self.request_timeout_s = request_timeout_s
        # Bounded queue = backpressure: about 8 batches of headroom, then
        # an immediate 503 instead of a slot that can only time out.
        self.max_queue = max_queue or max_batch * 8
        self.queue: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=self.max_queue)
        self.lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "errors": 0, "timeouts": 0, "rejected": 0,
                      "warmed_buckets": 0}
        self.latencies_ms: List[float] = []
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    # ---------------------------------------------------------- request side

    def submit(self, image, question: str, top_k: int,
               timeout_s: float = None):
        encoded, lengths = self.predictor.encode_questions([question])
        pending = _Pending(image, encoded[0], int(lengths[0]), top_k)
        # Counted at enqueue, so that /metrics shows the offered load.
        with self.lock:
            self.stats["requests"] += 1
        try:
            self.queue.put_nowait(pending)
        except queue.Full:
            with self.lock:
                self.stats["rejected"] += 1
            raise ServiceOverloaded(
                f"request queue full ({self.max_queue}); retry later"
            ) from None
        if timeout_s is None:
            timeout_s = self.request_timeout_s
        if not pending.event.wait(timeout_s):
            pending.abandoned = True
            with self.lock:
                self.stats["timeouts"] += 1
            raise TimeoutError("inference timed out")
        if pending.error:
            raise RuntimeError(pending.error)
        with self.lock:
            self.latencies_ms.append(
                (time.perf_counter() - pending.enqueued_at) * 1e3)
            del self.latencies_ms[:-1000]  # a bounded window
        return pending.result

    # ---------------------------------------------------------- batcher side

    def _drain(self) -> List[_Pending]:
        """Block for the next request (checking the stop flag every 250 ms),
        then coalesce stragglers up to the window or the limit. Returns []
        on stop."""
        batch: List[_Pending] = []
        while not self._stop.is_set():
            try:
                batch.append(self.queue.get(timeout=0.25))
                break
            except queue.Empty:
                continue
        if not batch:
            return batch
        deadline = time.perf_counter() + self.batch_window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _bucket(self, n: int) -> int:
        # Next power of two, clamped to the cap (a non-power-of-two
        # --max-batch never pads past it).
        size = 1
        while size < n:
            size *= 2
        return min(size, self.max_batch)

    def _run(self):
        import numpy as np

        while not self._stop.is_set():
            batch = self._drain()
            batch = [p for p in batch if not p.abandoned]
            if not batch:
                continue
            try:
                n = len(batch)
                size = self._bucket(n)
                max_len = self.predictor.max_question_length
                first = np.asarray(batch[0].image)
                images = np.zeros((size,) + first.shape, dtype=first.dtype)
                questions = np.zeros((size, max_len), dtype=np.int32)
                lengths = np.ones(size, dtype=np.int32)
                for i, p in enumerate(batch):
                    images[i] = p.image
                    questions[i] = p.encoded
                    lengths[i] = p.length
                probs = self.predictor.forward_probs(images, questions,
                                                     lengths)
                for i, p in enumerate(batch):
                    p.result = self.predictor.top_k_from_probs(probs[i],
                                                               p.top_k)
                    p.event.set()
                with self.lock:
                    self.stats["batches"] += 1
                    self.stats["batched_requests"] += n
            except Exception as exc:  # noqa: BLE001 - reported to callers
                with self.lock:
                    self.stats["errors"] += len(batch)
                for p in batch:
                    p.error = f"{type(exc).__name__}: {exc}"
                    p.event.set()

    def warmup(self, image_shape=None, block: bool = False):
        """Run every batch bucket once (ascending) on zero uint8 images, so
        that no request pays a shape's first launch or cuDNN's choice of
        algorithm. Runs on a background thread unless ``block``; small
        buckets come first. Counts ``warmed_buckets``."""
        import numpy as np

        if image_shape is None:
            s = self.predictor.image_size
            image_shape = (s, s, 3)
        max_len = self.predictor.max_question_length

        def run():
            size = 1
            while True:
                bucket = self._bucket(size)  # the served shapes
                try:
                    self.predictor.forward_probs(
                        np.zeros((bucket,) + tuple(image_shape), np.uint8),
                        np.zeros((bucket, max_len), np.int32),
                        np.ones(bucket, np.int32))
                except Exception:  # noqa: BLE001 - warmup must not die mute
                    import logging

                    logging.getLogger(__name__).exception(
                        "serving warmup failed at bucket %d; later requests "
                        "in unwarmed buckets pay their first launch", bucket)
                    return
                with self.lock:
                    self.stats["warmed_buckets"] += 1
                if bucket == self.max_batch:
                    break
                size *= 2

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        if block:
            thread.join()
        return thread

    def metrics(self) -> dict:
        with self.lock:
            lat = list(self.latencies_ms)
            out = dict(self.stats)
        out["mean_batch_size"] = (
            round(out["batched_requests"] / out["batches"], 2)
            if out["batches"] else 0.0)
        if lat:
            ordered = sorted(lat)
            out["latency_p50_ms"] = round(statistics.median(ordered), 2)
            out["latency_p99_ms"] = round(
                ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))], 2)
        return out

    def stop(self):
        self._stop.set()


class _HTTPServer(ThreadingHTTPServer):
    # The listen backlog of the native front: socketserver's default of 5
    # resets connections when more clients than that connect at once.
    request_queue_size = 128


def make_handler(service: BatchingService, predictor):
    import torch

    device = predictor.device  # /healthz: its type, and the card's name
    health = {"status": "ok", "backend": device.type,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else device.type)}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *_args):  # quiet server logs
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, health)
            elif self.path == "/metrics":
                self._reply(200, service.metrics())
            else:
                self._reply(404, {"error": "not found"})

        MAX_BODY_BYTES = 32 << 20  # bounds host memory per request

        def do_POST(self):
            if self.path != "/v1/answer":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                # A negative Content-Length would make rfile.read(-1) read
                # to EOF, past the cap.
                if length <= 0 or length > self.MAX_BODY_BYTES:
                    self._reply(
                        413 if length > 0 else 400,
                        {"error": "bad or missing Content-Length"
                         if length <= 0 else "request body too large"})
                    return
                req = json.loads(self.rfile.read(length))
                question = req["question"]
                if not isinstance(question, str):
                    raise ValueError("'question' must be a string")
                top_k = int(req.get("top_k", 5))
                if top_k < 1:
                    raise ValueError("'top_k' must be >= 1")
                raw = base64.b64decode(req["image_b64"])
                image = predictor.preprocess_image(raw)
            except UnsupportedImage as exc:
                self._reply(415, {"error": str(exc)})
                return
            except Exception as exc:  # noqa: BLE001 - bad request
                self._reply(400, {"error": f"bad request: {exc}"})
                return
            try:
                answers = service.submit(image, question, top_k)
                self._reply(200, {"answers": answers})
            except ServiceOverloaded as exc:
                self._reply(503, {"error": str(exc)})
            except TimeoutError as exc:
                self._reply(504, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 - inference failure
                self._reply(500, {"error": str(exc)})

    return Handler


MAX_CALIBRATION_IMAGES = 256


def _calibrate_int8(predictor, calibration_dir: Optional[str]) -> None:
    """Calibrate the int8 mode (``train.image.store_dtype=int8``) on a
    directory of representative images (``*.jpg``, ``*.jpeg``, ``*.png``,
    ``*.bmp``, as the JAX front globs them) before the first forward: its
    scales are fixed at startup, not per request. A directory with none
    fails here rather than calibrating on nothing."""
    import glob
    import os

    if not calibration_dir:
        raise SystemExit(
            "train.image.store_dtype=int8 needs static activation scales: "
            "pass --int8-calibration-dir <dir of representative "
            "images> (or set image.quant_scales programmatically)")
    paths = sorted(
        p for p in glob.glob(os.path.join(calibration_dir, "*"))
        if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    if not paths:
        raise SystemExit(
            f"--int8-calibration-dir {calibration_dir!r} contains no "
            "images (*.jpg, *.jpeg, *.png, *.bmp)")
    if len(paths) > MAX_CALIBRATION_IMAGES:
        # An even spread over the sorted directory, not its first files.
        import numpy as np

        paths = [paths[i] for i in np.linspace(
            0, len(paths) - 1, MAX_CALIBRATION_IMAGES).astype(int)]
    predictor.calibrate_int8(predictor.load_images(paths))
    print(f"int8 mode: calibrated on {len(paths)} images -> scales "
          f"{predictor.model_cfg.image.quant_scales}")


def _predictor(cfg, device, int8_calibration_dir):
    from dl_vqa_tpu_torch.predict import Predictor

    predictor = Predictor.from_config(cfg, device=device)
    if predictor.needs_int8_calibration:
        _calibrate_int8(predictor, int8_calibration_dir)
    return predictor


def build_server(cfg, port: int = 0, max_batch: int = 64,
                 batch_window_ms: float = 5.0, host: str = "127.0.0.1",
                 request_timeout_s: float = 300.0, max_queue: int = 0,
                 warmup: bool = False, int8_calibration_dir: str = None,
                 device=DEFAULT_DEVICE):
    """Returns (ThreadingHTTPServer, BatchingService); port 0 = ephemeral.
    ``warmup=True`` starts the background sweep of the batch buckets
    (:meth:`BatchingService.warmup`)."""
    predictor = _predictor(cfg, device, int8_calibration_dir)
    service = BatchingService(predictor, max_batch=max_batch,
                              batch_window_ms=batch_window_ms,
                              request_timeout_s=request_timeout_s,
                              max_queue=max_queue)
    if warmup:
        service.warmup()
    server = _HTTPServer((host, port), make_handler(service, predictor))
    return server, service


def build_native_server(cfg, port: int = 0, max_batch: int = 64,
                        batch_window_ms: float = 5.0,
                        host: str = "127.0.0.1",
                        request_timeout_s: float = 300.0,
                        max_queue: int = 0, warmup: bool = False,
                        int8_calibration_dir: str = None,
                        topk_cap: int = 16, device=DEFAULT_DEVICE):
    """Native-front variant of :func:`build_server`: the per-request path
    (HTTP, JSON, base64, JPEG decode, tokenize, queueing, batching,
    response writes) runs in C++ threads (``native/serve_front.cc``);
    Python runs the dispatch loop. Returns a :class:`dl_vqa_tpu_torch.
    utils.native_front.NativeFrontService` whose dispatch thread is not yet
    running: call ``service.start_dispatch()`` (background) or
    ``service.dispatch_forever()`` (foreground)."""
    from dl_vqa_tpu_torch.utils.native_front import NativeFrontService

    predictor = _predictor(cfg, device, int8_calibration_dir)
    service = NativeFrontService(
        predictor, host=host, port=port, max_batch=max_batch,
        batch_window_ms=batch_window_ms, max_queue=max_queue,
        request_timeout_s=request_timeout_s, topk_cap=topk_cap)
    if warmup:
        service.warmup()
    return service


def main(argv=None) -> int:
    from dl_vqa_tpu_torch import config as config_mod

    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (0.0.0.0 for off-host clients)")
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--batch-window-ms", type=float, default=5.0)
    parser.add_argument("--request-timeout-s", type=float, default=300.0)
    parser.add_argument("--max-queue", type=int, default=0,
                        help="bounded request queue (backpressure): "
                             "excess submits get 503; 0 = 8*max_batch")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the background sweep of the batch "
                             "buckets (the first request of each then pays "
                             "its first launch)")
    parser.add_argument("--native-front", action="store_true",
                        help="serve through the C++ front "
                             "(native/serve_front.cc): HTTP/JSON/base64/"
                             "JPEG-decode/tokenize/batching in native "
                             "threads, Python only dispatches the forward; "
                             "needs libjpeg on the host")
    parser.add_argument("--topk-cap", type=int, default=16,
                        help="native front only: the widest top-k it "
                             "returns (requests asking for more get 400)")
    parser.add_argument("--int8-calibration-dir", default=None,
                        help="directory of representative images "
                             "(*.jpg, *.jpeg, *.png, *.bmp) to "
                             "calibrate the int8 mode on (required when "
                             "train.image.store_dtype=int8 without preset "
                             "image.quant_scales)")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="where the model runs (default: the GPU)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = config_mod.compose("config_eval", overrides=args.overrides)
    if args.native_front:
        service = build_native_server(
            cfg, port=args.port, max_batch=args.max_batch,
            batch_window_ms=args.batch_window_ms, host=args.host,
            request_timeout_s=args.request_timeout_s,
            max_queue=args.max_queue, warmup=not args.no_warmup,
            int8_calibration_dir=args.int8_calibration_dir,
            topk_cap=args.topk_cap, device=args.device)
        print(f"serving on http://{args.host}:{service.port} "
              f"(native front, max_batch={args.max_batch}, "
              f"window={args.batch_window_ms}ms)", flush=True)
        try:
            service.dispatch_forever()
        finally:
            service.stop()
        return 0
    server, service = build_server(
        cfg, port=args.port, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms, host=args.host,
        request_timeout_s=args.request_timeout_s,
        max_queue=args.max_queue, warmup=not args.no_warmup,
        int8_calibration_dir=args.int8_calibration_dir, device=args.device)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(max_batch={args.max_batch}, window={args.batch_window_ms}ms)",
          flush=True)
    try:
        server.serve_forever()
    finally:
        service.stop()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
