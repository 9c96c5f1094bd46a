"""Batched VQA inference with the PyTorch port.

Port of ``predict.py::Predictor`` (its array path): questions are
tokenized and encoded exactly as in training (the port's own copies of
the tokenizer and the question encoder, :mod:`dl_vqa_tpu_torch.data.text`),
images arrive as ``[B, H, W, 3]`` arrays (uint8 pixels, normalised on the
device, or already-normalised floats), and answers come back as top-k
``(answer, probability)`` lists.

``device`` is the GPU unless the caller passes another; nothing here
moves work to another device, and without a GPU the default raises.

The quantized serving modes follow the model configuration's
``image.store_dtype``: ``f8e4m3`` serves at once; ``int8`` needs static
activation scales, which a calibrate-once checkpoint carries in its
metadata (adopted at load) or :meth:`Predictor.calibrate_int8` measures on
sample images (and can save into a new checkpoint).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dl_vqa_tpu_torch.data.text import encode_question, normalize_question
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["Predictor"]

_LEGACY_QUESTION_LENGTH = 23


class Predictor:
    """Serving-side wrapper of a :class:`VqaNet` on one device."""

    def __init__(self, model_cfg: ModelConfig, model: VqaNet,
                 vocab: Dict[str, Dict[str, int]], *, device=DEFAULT_DEVICE,
                 max_question_length: int = _LEGACY_QUESTION_LENGTH,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fused_ops: bool = False):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.model = model.to(self.device).eval()
        if model.cfg != model_cfg:  # a serving mode of the same weights
            model.configure(model_cfg)
        self.vocab = vocab
        self.question_vocab = vocab["question"]
        self.answer_by_id = {idx: ans for ans, idx in vocab["answer"].items()}
        self.max_question_length = int(max_question_length)
        self.compute_dtype = compute_dtype
        self.fused_ops = fused_ops  # see VqaNet.forward
        self.checkpoint_meta: Dict = {}  # the metadata it was loaded with

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, vocab_path: str, *,
                        device=DEFAULT_DEVICE,
                        model_cfg: Optional[ModelConfig] = None,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> "Predictor":
        """Load an npz checkpoint of ``dl_vqa_tpu`` and its ``vocab.json``.
        The model configuration comes from the checkpoint's metadata
        unless ``model_cfg`` is given."""
        import json

        from dl_vqa_tpu_torch.utils.checkpoint import load_params
        from dl_vqa_tpu_torch.utils.params import load_jax_params

        device = resolve_device(device)
        with open(vocab_path) as fd:
            vocab = json.load(fd)
        params, meta = load_params(checkpoint_path, with_meta=True)
        if model_cfg is None:
            if not meta.get("model_cfg"):
                raise ValueError(
                    f"{checkpoint_path!r} carries no model_cfg metadata; "
                    "pass model_cfg")
            model_cfg = ModelConfig.from_meta_dict(meta["model_cfg"])
        # A calibrate-once checkpoint carries the int8 mode's scales: adopt
        # them, so that a restart needs no calibration data.
        model_cfg = model_cfg.with_checkpoint_scales(meta)
        if meta.get("max_question_length"):
            max_len = int(meta["max_question_length"])
        else:
            max_len = _LEGACY_QUESTION_LENGTH
            warnings.warn(
                f"checkpoint {checkpoint_path!r} carries no "
                "max_question_length metadata; assuming the reference "
                f"default of {max_len} tokens. Longer questions are "
                "truncated.", stacklevel=2)
        model = load_jax_params(VqaNet(model_cfg, device=device), params)
        predictor = cls(model_cfg, model, vocab, device=device,
                        max_question_length=max_len,
                        compute_dtype=compute_dtype)
        predictor.checkpoint_meta = meta
        return predictor

    @property
    def needs_int8_calibration(self) -> bool:
        """True while the configuration asks for the int8 mode and no
        scales are set: a forward raises until :meth:`calibrate_int8`."""
        return (self.model_cfg.image.store_dtype == "int8"
                and not self.model_cfg.image.quant_scales)

    def calibrate_int8(self, images, save_to: Optional[str] = None) -> None:
        """Calibrate the int8 mode's static scales on a representative
        ``[B, H, W, 3]`` sample (uint8 pixels or normalised floats) and serve
        with them from now on: the CNN's one scale a conv block
        (``ops/conv_int8.py``), the ViT's four a block
        (``ops/vit_int8.py``). ``save_to``: also write the parameters with
        the calibrated ``model_cfg`` in the metadata, carrying the loaded
        checkpoint's other metadata through (``max_question_length`` only
        where it had one), so later starts need no calibration data."""
        from dl_vqa_tpu_torch.utils.checkpoint import save_params

        cfg = self.model.int8_calibrated(torch.as_tensor(np.asarray(images)),
                                         dtype=self.compute_dtype)
        self.model.configure(cfg)
        self.model_cfg = cfg
        if save_to:
            extra = {k: v for k, v in self.checkpoint_meta.items()
                     if k not in ("model_cfg", "epoch")}
            save_params(save_to, self.model, model_cfg=cfg,
                        epoch=self.checkpoint_meta.get("epoch"),
                        extra_meta=extra)

    def encode_questions(self, questions: Sequence[str],
                         max_len: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """``([B, max_len] int32 ids, [B] int32 lengths)``; a missing "?"
        is appended and every length is at least 1."""
        if max_len is None:
            max_len = self.max_question_length
        encoded = np.zeros((len(questions), max_len), dtype=np.int32)
        lengths = np.zeros(len(questions), dtype=np.int32)
        for i, q in enumerate(questions):
            if not q.endswith("?"):
                q = q + "?"
            tokens = normalize_question(q)[:max_len]
            encoded[i], n = encode_question(tokens, self.question_vocab,
                                            max_len)
            lengths[i] = max(n, 1)
        return encoded, lengths

    @torch.inference_mode()
    def forward_logits(self, images, questions, lengths,
                       plain_ops: bool = False) -> np.ndarray:
        """``[B, max_answers]`` f32 logits on the host. ``plain_ops`` runs
        the kernels' plain PyTorch versions (see :meth:`VqaNet.forward`)."""
        logits = self.model(
            torch.as_tensor(images).to(self.device),
            torch.as_tensor(questions).to(self.device),
            torch.as_tensor(lengths).to(self.device),
            compute_dtype=self.compute_dtype, plain_ops=plain_ops,
            fused_ops=self.fused_ops)
        return logits.cpu().numpy()

    def forward_probs(self, images, questions, lengths) -> np.ndarray:
        """Softmax probabilities ``[B, max_answers]``."""
        logits = self.forward_logits(images, questions, lengths)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        return probs

    def top_k_from_probs(self, probs_row: np.ndarray, top_k: int
                         ) -> List[Tuple[str, float]]:
        """Answer ids are 1-based (0 is padding): column i is id i + 1."""
        order = np.argsort(probs_row)[::-1][:top_k]
        return [(self.answer_by_id.get(int(i) + 1, "<unk>"),
                 float(probs_row[i])) for i in order]

    def predict(self, images, questions: Sequence[str], top_k: int = 5
                ) -> List[List[Tuple[str, float]]]:
        """Top-k ``(answer, probability)`` per (image, question) pair;
        ``images`` is ``[B, H, W, 3]``."""
        if len(images) != len(questions):
            raise ValueError(f"{len(images)} images for {len(questions)} "
                             "questions")
        encoded, lengths = self.encode_questions(questions)
        probs = self.forward_probs(images, encoded, lengths)
        return [self.top_k_from_probs(row, top_k) for row in probs]
