"""Host input pipeline: fixed-shape batches, prefetched onto the card.

The port's copy of ``dl_vqa_tpu/data/pipeline.py``:

* :class:`Batcher` gives every batch the same shape (the last one is
  padded by repeating its last sample and carries a ``mask``); the sample
  order of an epoch derives from ``(seed, epoch)`` alone, so a resumed run
  skips the batches an interrupted one consumed (``iter_epoch(epoch,
  start_batch)``) and sees the batches the JAX package sees. Images come
  from the store per batch (fp16 NHWC), or, in table mode
  (``load_images=False``), a batch carries ``image_rows`` and the step
  gathers from the device image table; a subclass may add its own images
  in ``_finalize_batch`` (the online JPEG pipeline's uint8 NHWC).
* :func:`prefetch_to_device` runs the batch iterator on a producer thread
  that copies each batch into pinned host memory and, on a CUDA device,
  sends it over in a non-blocking copy on a side stream; the consumer's
  stream waits on the copy's event before the batch is used, and every
  tensor is ``record_stream``-ed to it, so its memory is not reused while
  the step reads it.

Multi-host slicing (``process_slice``) is not ported: it must be ``None``.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

__all__ = ["Batcher", "prefetch_to_device"]


class Batcher:
    """Iterate fixed-shape numpy batches over a
    :class:`~dl_vqa_tpu_torch.data.dataset.VQADataset`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, load_images: bool = True,
                 process_slice=None):
        if process_slice is not None:
            raise NotImplementedError(
                "Batcher(process_slice=...) is multi-host input sharding, "
                "not ported to dl_vqa_tpu_torch yet (ROADMAP queue 1, item "
                "9, the parallel axes)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.load_images = load_images
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)  # ceil

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The sample order of ``epoch``, from ``(seed, epoch)`` alone."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng([int(self.seed), int(epoch)]).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch, self._epoch = self._epoch, self._epoch + 1
        return self.iter_epoch(epoch)

    def iter_epoch(self, epoch: int, start_batch: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
        """``epoch``'s batches from batch ``start_batch`` on (a mid-epoch
        resume); does not advance the ``__iter__`` counter."""
        n = len(self.dataset)
        order = self.epoch_order(epoch)
        bs = self.batch_size
        for start in range(start_batch * bs, n, bs):
            idx = order[start:start + bs]
            real = len(idx)
            if real < bs:  # pad the last batch to the fixed shape
                idx = np.concatenate([idx, np.repeat(idx[-1], bs - real)])
            mask = np.arange(bs) < real
            batch = {
                "questions": self.dataset.questions[idx],
                "lengths": self.dataset.question_lengths[idx],
                "answer_indices": self.dataset.answer_indices[idx],
                "answer_values": self.dataset.answer_values[idx],
                "mask": mask,
                "indices": idx.astype(np.int32),
            }
            if hasattr(self.dataset, "answer_types"):
                batch["answer_types"] = self.dataset.answer_types[idx]
            if self.load_images:
                batch["images"] = self.dataset.load_images_nhwc(idx)
            elif getattr(self.dataset, "has_image_rows", False):
                batch["image_rows"] = self.dataset.h5_rows[idx].astype(
                    np.int32)
            yield self._finalize_batch(batch)

    def _finalize_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        """Applied to every batch ``iter_epoch`` yields: a subclass adds
        its images here (the online JPEG pipeline,
        :class:`dl_vqa_tpu_torch.data.online.OnlineBatcher`)."""
        return batch


def prefetch_to_device(iterator, device, depth: int = 2):
    """Stage ``depth`` batches of ``iterator`` ahead on ``device`` from a
    background thread; yields dicts of tensors on ``device``. ``depth <
    1`` copies each batch when it is asked for. A producer error is raised
    in the consumer; a consumer that stops early stops the producer."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if depth < 1:
        for batch in iterator:
            staged = _stage(batch, device, None)
            yield _ready(staged, device)
        return

    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    error_holder = []
    stop = threading.Event()

    def _put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            for batch in iterator:
                if not _put_or_stop(_stage(batch, device, side)):
                    return
        except BaseException as e:  # raised again in the consumer
            error_holder.append(e)
        finally:
            _put_or_stop(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error_holder:
                    raise error_holder[0]
                return
            yield _ready(item, device)
    finally:
        stop.set()
        while True:  # drop staged batches so the producer unblocks
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join()


def _stage(batch: Dict, device: torch.device, side):
    """A batch's arrays as tensors on ``device``, and the event its copy
    records (None where nothing is in flight). On CUDA each array goes
    through pinned memory and a non-blocking copy on the ``side`` stream;
    a tensor already on the device is left as it is."""
    tensors = {key: torch.as_tensor(value) for key, value in batch.items()}
    if device.type != "cuda":
        return {key: t.to(device) for key, t in tensors.items()}, None
    stream = side if side is not None else torch.cuda.current_stream(device)
    out = {}
    with torch.cuda.stream(stream):
        for key, t in tensors.items():
            if t.device == device:
                out[key] = t
                continue
            if not t.is_pinned():
                t = t.pin_memory()
            out[key] = t.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def _ready(staged, device: torch.device) -> Dict[str, torch.Tensor]:
    """Make the consumer's stream wait for the batch's copy and tie every
    copied tensor's memory to that stream."""
    batch, event = staged
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in batch.values():
            if t.device.type == "cuda":
                t.record_stream(current)
    return batch
