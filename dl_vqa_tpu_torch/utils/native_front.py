"""ctypes bindings and dispatch loop of the native (C++) serving front.

The port's copy of ``dl_vqa_tpu/utils/native_front.py``.
``native/serve_front.cc`` runs the serving daemon's per-request host path
in C++ threads: HTTP accept and parse, JSON, base64, in-memory JPEG decode
with the PIL-parity resize and crop (libjpeg), tokenization, bounded
queueing, batch coalescing and response formatting. Python runs the
dispatch loop of :class:`NativeFrontService`, which blocks in
``vqa_front_next_batch`` (ctypes releases the interpreter lock around the
call), runs one forward per batch and hands the top-k back to C++.

A batch's uint8 images land in a pinned host buffer and cross to the card
in one copy; the model normalises them there. The forward's f32 softmax is
ranked by a stable descending sort, so that ties go to the lower index as
``lax.top_k`` orders them (``torch.topk`` fixes no order on ties), and the
top ``topk_cap`` probabilities and their int32 indices, bitcast to f32,
come back in one tensor: one copy back a batch.

Behavioural contract against :class:`dl_vqa_tpu_torch.serve.
BatchingService`: the same endpoints, counter names, 503/504/500 mapping
and bucket shapes; JPEG images only (415 otherwise) and a cap on
``top_k``. The library is ``libvqa_torch_serve.so``, built from
``native/`` on first use (:mod:`dl_vqa_tpu_torch.ops._host`); it needs
libjpeg on the host.
"""

from __future__ import annotations

import ctypes
import json
import socket
import threading
from typing import Optional

import numpy as np
import torch

__all__ = ["load_native_serve_library", "NativeFrontService"]


def load_native_serve_library():
    """The loaded front library, built on first call; raises, naming what
    is missing, where it cannot be built."""
    from dl_vqa_tpu_torch.ops import _host

    return _host.library("serve")


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _ipv4(host: str) -> str:
    """``host`` as a dotted quad (IPv4 only, as the front binds)."""
    try:
        return socket.gethostbyname(host)
    except (socket.gaierror, UnicodeError) as exc:
        raise RuntimeError(
            f"vqa_front_start failed (code 2): cannot resolve host {host!r} "
            f"(IPv4 only): {exc}") from None


class NativeFrontService:
    """Owns one native front and the Python dispatch loop over a Predictor.

    One instance per process (the C++ side holds a process-global front):
    :meth:`stop` the previous instance before starting another.
    """

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 64, batch_window_ms: float = 5.0,
                 max_queue: int = 0, request_timeout_s: float = 300.0,
                 topk_cap: int = 16, max_conns: int = 512):
        self.lib = load_native_serve_library()
        self.predictor = predictor
        self.device = predictor.device
        self.max_batch = max_batch
        self.image_size = predictor.image_size
        self.max_question_length = predictor.max_question_length
        # The returned top-k cannot be wider than the answer vocab.
        self.topk_cap = min(topk_cap, predictor.model_cfg.max_answers)

        rc = self.lib.vqa_front_start(
            _ipv4(host).encode(), port, self.image_size,
            float(predictor.central_fraction), max_batch,
            int(batch_window_ms * 1000), max_queue,
            self.max_question_length, self.topk_cap,
            float(request_timeout_s), max_conns)
        if rc != 0:
            detail = {
                3: f"cannot bind {host}:{port} (port in use?)",
                4: "listen() failed",
                5: "another native front is still running in this "
                   "process; stop() it first",
            }.get(rc, "socket setup failed")
            raise RuntimeError(f"vqa_front_start failed (code {rc}): {detail}")
        # The listener is live from here on: if the rest of the setup
        # fails, stop it before raising, or the orphan keeps the process's
        # front and every retry fails with code 5.
        try:
            self.port = int(self.lib.vqa_front_port())
            # Every batch-side call names the front it was built against,
            # so a stale dispatch thread cannot fill a replaced front's
            # buffers (C++ checks and refuses).
            self._gen = int(self.lib.vqa_front_generation())
            self._upload_vocab()
            self.lib.vqa_front_set_backend(self.device.type.encode())

            self._fwd = self._build_forward()
            self._stop = threading.Event()
            self._dispatch_thread: Optional[threading.Thread] = None

            # The handoff buffers C++ copies a batch into; the images in
            # pinned memory on a CUDA device, for one asynchronous copy.
            images = torch.zeros(
                (max_batch, self.image_size, self.image_size, 3),
                dtype=torch.uint8)
            if self.device.type == "cuda":
                images = images.pin_memory()
            self._images_t = images
            self._images = images.numpy()
            self._questions = np.zeros(
                (max_batch, self.max_question_length), dtype=np.int32)
            self._lengths = np.ones(max_batch, dtype=np.int32)
            self._topks = np.zeros(max_batch, dtype=np.int32)
        except BaseException:
            self.lib.vqa_front_stop()
            raise

    # ------------------------------------------------------------- setup

    def _upload_vocab(self):
        p = self.predictor
        words = list(p.question_vocab.items())
        if any("\n" in w for w, _ in words):
            raise ValueError("question vocab contains a newline")
        blob = "".join(w + "\n" for w, _ in words).encode()
        ids = np.asarray([i for _, i in words], dtype=np.int32)
        rc = self.lib.vqa_front_set_question_vocab(blob, _i32ptr(ids),
                                                   len(words))
        if rc != 0:
            raise RuntimeError(f"vqa_front_set_question_vocab failed ({rc})")

        # Answer line i is the 1-based answer id i + 1.
        n = p.model_cfg.max_answers
        answers = [p.answer_by_id.get(i + 1, "<unk>") for i in range(n)]
        if any("\n" in a for a in answers):
            raise ValueError("answer vocab contains a newline")
        rc = self.lib.vqa_front_set_answers(
            "".join(a + "\n" for a in answers).encode(), n)
        if rc != 0:
            raise RuntimeError(f"vqa_front_set_answers failed ({rc})")

    def _build_forward(self):
        """``fwd(images_u8, questions, lengths) -> [B, 2k] f32`` on the
        device: the top-k probabilities, then their indices bitcast."""
        p = self.predictor
        k = self.topk_cap

        def fwd(images_u8, questions, lengths):
            with torch.inference_mode():
                logits = p.model(images_u8, questions, lengths,
                                 compute_dtype=p.compute_dtype,
                                 fused_ops=p.fused_ops)
                probs = torch.softmax(logits.float(), dim=-1)
                top_p, top_i = torch.sort(probs, dim=-1, descending=True,
                                          stable=True)
                return torch.cat(
                    [top_p[:, :k],
                     top_i[:, :k].to(torch.int32).view(torch.float32)],
                    dim=1)

        return fwd

    # ----------------------------------------------------------- dispatch

    def _bucket(self, n: int) -> int:
        size = 1
        while size < n:
            size *= 2
        return min(size, self.max_batch)

    def _run_forward(self, n: int):
        """Pad the first ``n`` handoff rows to the bucket and run the
        forward -> (top_p, top_i) numpy ``[n, k]``."""
        size = self._bucket(n)
        self._images[n:size] = 0
        self._questions[n:size] = 0
        self._lengths[n:size] = 1
        images = self._images_t[:size].to(self.device, non_blocking=True)
        questions = torch.from_numpy(self._questions[:size]).to(self.device)
        lengths = torch.from_numpy(self._lengths[:size]).to(self.device)
        # One copy back; it also orders the next batch's writes into the
        # pinned buffer after this batch's copy from it.
        packed = self._fwd(images, questions, lengths).cpu().numpy()
        k = self.topk_cap
        top_p = np.ascontiguousarray(packed[:n, :k])
        top_i = np.ascontiguousarray(packed[:n, k:]).view(np.int32)
        return top_p, top_i

    def _dispatch_loop(self):
        out_n = ctypes.c_int32(0)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index or 0)
        while not self._stop.is_set():
            batch_id = self.lib.vqa_front_next_batch(
                self._gen,
                self._images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                _i32ptr(self._questions), _i32ptr(self._lengths),
                _i32ptr(self._topks), ctypes.byref(out_n), 500)
            if batch_id == -2:
                return  # front stopped
            if batch_id < 0 or out_n.value == 0:
                continue
            try:
                top_p, top_i = self._run_forward(out_n.value)
                self.lib.vqa_front_complete(
                    self._gen, batch_id, _i32ptr(top_i),
                    top_p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    self.topk_cap)
            except Exception as exc:  # noqa: BLE001 - reported to clients
                self.lib.vqa_front_fail(
                    self._gen, batch_id,
                    f"{type(exc).__name__}: {exc}".encode())

    def start_dispatch(self):
        """Run the dispatch loop on a daemon thread (tests and library use;
        the entry point runs :meth:`dispatch_forever` in the foreground)."""
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, daemon=True)
        self._dispatch_thread.start()
        return self._dispatch_thread

    def dispatch_forever(self):
        self._dispatch_loop()

    # ------------------------------------------------------------- extras

    def warmup(self, block: bool = False):
        """Run every batch bucket once, ascending (each shape's first
        launch and cuDNN's choice of algorithm), counting the
        ``warmed_buckets`` gauge as :meth:`dl_vqa_tpu_torch.serve.
        BatchingService.warmup` counts it."""
        def run():
            size = 1
            warmed = 0
            while True:
                bucket = self._bucket(size)
                try:
                    s = self.image_size
                    self._fwd(
                        torch.zeros((bucket, s, s, 3), dtype=torch.uint8,
                                    device=self.device),
                        torch.zeros((bucket, self.max_question_length),
                                    dtype=torch.int32, device=self.device),
                        torch.ones(bucket, dtype=torch.int32,
                                   device=self.device)).cpu()
                except Exception:  # noqa: BLE001 - warmup must not die mute
                    import logging

                    logging.getLogger(__name__).exception(
                        "native-front warmup failed at bucket %d", bucket)
                    return
                warmed += 1
                self.lib.vqa_front_set_gauge(b"warmed_buckets", warmed)
                if bucket == self.max_batch:
                    break
                size *= 2

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        if block:
            thread.join()
        return thread

    def metrics(self) -> dict:
        buf = ctypes.create_string_buffer(4096)
        self.lib.vqa_front_metrics_json(buf, len(buf))
        return json.loads(buf.value.decode())

    def tokenize(self, question: str) -> tuple:
        """Test hook: the C++ tokenizer's (ids, length) for one question."""
        ids = np.zeros(self.max_question_length, dtype=np.int32)
        n = self.lib.vqa_front_tokenize(question.encode(), _i32ptr(ids),
                                        self.max_question_length)
        if n < 0:
            raise RuntimeError(f"vqa_front_tokenize failed ({n})")
        return ids, n

    def stop(self):
        self._stop.set()
        self.lib.vqa_front_stop()
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout=5.0)
