"""AOT serving artifacts of the port: the serving forward as
``torch.export`` programs.

Port of ``dl_vqa_tpu/utils/aot_export.py``. :func:`export_artifact`
writes a directory holding the serving forward as one ``torch.export``
program a batch bucket, the weights, and the decode metadata. A consumer
process loads it with :func:`load_artifact` and serves: no model code, no
config system, no tracing. The loader imports ``torch``, ``numpy`` and
the op modules that register the ``vqa::`` custom ops the programs call
(:data:`OP_MODULES`; every hand kernel of the serving forward is one such
node), and nothing of ``dl_vqa_tpu_torch.models``, ``.config``, ``.data``,
``.train``, ``.predict`` or ``.serve``. The numerics are frozen at export:
the compute dtype, ``fused_ops``, the serving mode and its calibrated int8
scales are compiled into the programs.

Layout of an artifact directory::

    meta.json          version, batch buckets, image size, central
                       fraction, max question length, the question and
                       answer vocabularies, the device type it was
                       exported on, and what the exporter adds (the
                       Predictor: compute dtype, fused_ops, store mode)
    params.npz         f32 weights, keys the port's state-dict names
    forward_b{N}.pt2   the exported forward at batch N

Each program's signature is ``(params, images[f32 B,H,W,3],
questions[i32 B,L], lengths[i32 B]) -> logits[f32 B,A]``, with ``params``
a dict of the weights by name and the images normalised, as in the JAX
artifact. The weights stay arguments (``torch.func.functional_call``), not
constants of the programs, so one artifact serves any weight set of the
same topology.
"""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["export_artifact", "load_artifact", "ServingArtifact",
           "ARTIFACT_VERSION", "OP_MODULES"]

ARTIFACT_VERSION = 1

# The modules that register the vqa:: custom ops of the serving forward.
OP_MODULES = (
    "dl_vqa_tpu_torch.ops.lstm",
    "dl_vqa_tpu_torch.ops.conv_fused",
    "dl_vqa_tpu_torch.ops.conv_int8",
    "dl_vqa_tpu_torch.ops.attention_pool",
    "dl_vqa_tpu_torch.ops.vit_attention",
    "dl_vqa_tpu_torch.ops.vit_mlp_fused",
)


class _Forward(torch.nn.Module):
    """``torch.export`` takes a module; this one holds only the callable,
    so that no weight becomes a parameter or a constant of the program."""

    def __init__(self, forward: Callable):
        super().__init__()
        self.fn = forward

    def forward(self, params, images, questions, lengths):
        return self.fn(params, images, questions, lengths)


def export_artifact(
    path: str,
    params: Dict[str, torch.Tensor],
    forward: Callable,
    *,
    batch_sizes: Sequence[int],
    image_size: int,
    max_question_length: int,
    vocab: Dict,
    central_fraction: float = 0.875,
    extra_meta: Optional[Dict] = None,
) -> Dict[int, float]:
    """Export ``forward(params, images, questions, lengths) -> logits`` at
    each batch bucket into the artifact directory ``path``, on the device
    of ``params`` (which every program is then bound to), under
    ``torch.no_grad()``. Returns the seconds each bucket took (tracing
    and writing its program)."""
    device = next(iter(params.values())).device
    os.makedirs(path, exist_ok=True)
    module = _Forward(forward)
    seconds = {}
    for bs in batch_sizes:
        args = (params,
                torch.zeros(bs, image_size, image_size, 3, device=device),
                torch.zeros(bs, max_question_length, dtype=torch.int32,
                            device=device),
                torch.ones(bs, dtype=torch.int32, device=device))
        start = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(module, args)
        # The program keeps its example inputs, the weights among them;
        # the artifact stores the weights once, in params.npz.
        program.example_inputs = None
        torch.export.save(program, os.path.join(path, f"forward_b{bs}.pt2"))
        seconds[int(bs)] = time.perf_counter() - start

    np.savez(os.path.join(path, "params.npz"),
             **{name: t.detach().float().cpu().numpy()
                for name, t in params.items()})
    meta = {
        "version": ARTIFACT_VERSION,
        "batch_sizes": sorted(int(b) for b in batch_sizes),
        "image_size": int(image_size),
        "central_fraction": float(central_fraction),
        "max_question_length": int(max_question_length),
        "device_type": device.type,
        # Answer ids are 1-based (vocab.json): logits column c decodes as
        # answer id c + 1.
        "question_vocab": vocab["question"],
        "answer_vocab": vocab["answer"],
    }
    meta.update(extra_meta or {})
    with open(os.path.join(path, "meta.json"), "w") as fd:
        json.dump(meta, fd)
    return seconds


class ServingArtifact:
    """A loaded artifact on one device: batched :meth:`logits` and answer
    decoding. A batch above the largest bucket is split; a smaller one is
    padded up to the nearest bucket (rows are independent in this model
    family, so the padding changes no real row), and every length is
    clamped to at least 1."""

    def __init__(self, path: str, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        with open(os.path.join(path, "meta.json")) as fd:
            self.meta = json.load(fd)
        if self.meta["version"] > ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {self.meta['version']} is newer than "
                f"this loader ({ARTIFACT_VERSION})")
        if self.meta["device_type"] != self.device.type:
            raise ValueError(
                f"artifact was exported for {self.meta['device_type']!r} "
                f"devices and cannot run on {self.device.type!r}: its "
                f"programs are bound to the device they were exported on; "
                f"re-export on a {self.device.type} device")
        for name in OP_MODULES:
            importlib.import_module(name)  # registers the vqa:: ops
        with np.load(os.path.join(path, "params.npz")) as z:
            self.params = {k: torch.from_numpy(z[k]).to(self.device)
                           for k in z.files}
        self.batch_sizes = self.meta["batch_sizes"]
        self._calls = {
            bs: torch.export.load(
                os.path.join(path, f"forward_b{bs}.pt2")).module()
            for bs in self.batch_sizes}
        self.max_question_length = self.meta["max_question_length"]
        self.image_size = self.meta["image_size"]
        self.answer_by_id = {
            int(i): a for a, i in self.meta["answer_vocab"].items()}

    def _bucket(self, n: int) -> int:
        for bs in self.batch_sizes:
            if n <= bs:
                return bs
        return self.batch_sizes[-1]

    def logits(self, images, questions, lengths) -> np.ndarray:
        """``[B,H,W,3]`` f32, ``[B,L]`` i32, ``[B]`` i32 -> ``[B, answers]``
        f32 on the host, any B."""
        images = np.asarray(images, np.float32)
        questions = np.asarray(questions, np.int32)
        lengths = np.asarray(lengths, np.int32)
        n = images.shape[0]
        out = []
        start = 0
        while start < n:
            bs = self._bucket(n - start)
            take = min(bs, n - start)

            def padded(x):
                block = x[start:start + take]
                if take == bs:
                    return block
                return np.pad(block, [(0, bs - take)] + [(0, 0)] * (x.ndim - 1))

            args = (padded(images), padded(questions),
                    np.maximum(padded(lengths), 1))
            with torch.inference_mode():
                block = self._calls[bs](
                    self.params,
                    *(torch.from_numpy(a).to(self.device) for a in args))
            out.append(block[:take].cpu().numpy())
            start += take
        return np.concatenate(out, axis=0)

    def answers(self, images, questions, lengths):
        """argmax decode -> one answer string a row."""
        preds = self.logits(images, questions, lengths).argmax(axis=1)
        return [self.answer_by_id.get(int(p) + 1, "<unk>") for p in preds]


def load_artifact(path: str, device=DEFAULT_DEVICE) -> ServingArtifact:
    """The artifact under ``path`` on ``device``: the GPU unless the caller
    passes another; without one the default raises."""
    return ServingArtifact(path, device)
