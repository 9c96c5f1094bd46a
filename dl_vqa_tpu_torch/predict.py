"""Batched VQA inference with the PyTorch port, and its command line.

Port of ``predict.py``: questions are tokenized and encoded exactly as in
training (the port's own copies of the tokenizer and the question
encoder, :mod:`dl_vqa_tpu_torch.data.text`), images arrive as JPEG, PNG
or BMP files or bytes (decoded to uint8 pixels by
:mod:`dl_vqa_tpu_torch.data.images`' exact decoder, PIL's pixels, its last
stages on the model's device) or as ``[B, H, W, 3]`` arrays
(uint8 pixels, normalised on the device, or already-normalised floats),
and answers come back as top-k ``(answer, probability)`` lists.

    python -m dl_vqa_tpu_torch.predict [overrides...] --image cat.jpg \
        --question "what animal is this?"
    python -m dl_vqa_tpu_torch.predict --submission results.json \
        [overrides...]
    python -m dl_vqa_tpu_torch.predict --export-artifact DIR \
        [--export-batch-sizes 1,8] [overrides...]

The second writes the official VQA submission over the val split, the
third an AOT serving artifact (:mod:`dl_vqa_tpu_torch.utils.aot_export`),
which a process loads and serves without the model code. The
overrides are those of the ``config_eval`` preset
(``main.small.paths.pretrained_model_path=...`` and so on); the model is
built from the config, as there. ``--device cpu`` runs on the CPU.

``device`` is the GPU unless the caller passes another; nothing here
moves work to another device, and without a GPU the default raises.

The quantized serving modes follow the model configuration's
``image.store_dtype``: ``f8e4m3`` serves at once; ``int8`` needs static
activation scales, which a calibrate-once checkpoint carries in its
metadata (adopted at load) or :meth:`Predictor.calibrate_int8` measures on
sample images (and can save into a new checkpoint).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dl_vqa_tpu_torch.data.images import (
    decode_image, decoder_for, device_index_of, load_image_files)
from dl_vqa_tpu_torch.data.text import encode_question, normalize_question
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["Predictor", "main"]

_LEGACY_QUESTION_LENGTH = 23


class Predictor:
    """Serving-side wrapper of a :class:`VqaNet` on one device."""

    def __init__(self, model_cfg: ModelConfig, model: VqaNet,
                 vocab: Dict[str, Dict[str, int]], *, device=DEFAULT_DEVICE,
                 max_question_length: int = _LEGACY_QUESTION_LENGTH,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fused_ops: bool = False, central_fraction: float = 0.875):
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
        self.central_fraction = float(central_fraction)
        self.decoder = decoder_for(self.device)  # see data.images

    @property
    def image_size(self) -> int:
        return self.model_cfg.image_size

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, vocab_path: str, *,
                        device=DEFAULT_DEVICE,
                        model_cfg: Optional[ModelConfig] = None,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        central_fraction: float = 0.875) -> "Predictor":
        """Load an npz checkpoint of ``dl_vqa_tpu`` and its ``vocab.json``.
        The model configuration comes from the checkpoint's metadata
        unless ``model_cfg`` is given."""
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
                        compute_dtype=compute_dtype,
                        central_fraction=central_fraction)
        predictor.checkpoint_meta = meta
        return predictor

    @classmethod
    def from_config(cls, cfg: dict, device=DEFAULT_DEVICE) -> "Predictor":
        """The predictor the entry points serve: the checkpoint and vocab of
        the composed config's profile, the model built from ``cfg["train"]``
        (as the JAX package's ``Predictor`` builds it, with the question
        vocab's size + 1 tokens), ``tpu.compute_dtype``, and the train
        section's ``central_fraction``."""
        from dl_vqa_tpu_torch.main import compute_dtype_of

        profile = cfg["main"]["full" if cfg["main"]["use_full"] else "small"]
        vocab_path = profile["paths"]["vocab_path"]
        with open(vocab_path) as fd:
            num_tokens = len(json.load(fd)["question"]) + 1
        model_cfg = ModelConfig.from_cfg(cfg["train"], num_tokens,
                                         use_pallas=cfg["tpu"]["use_pallas"])
        return cls.from_checkpoint(
            profile["paths"]["pretrained_model_path"], vocab_path,
            device=device, model_cfg=model_cfg,
            compute_dtype=compute_dtype_of(cfg),
            central_fraction=cfg["train"]["central_fraction"])

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

    def preprocess_image(self, raw: bytes) -> np.ndarray:
        """JPEG, PNG or BMP bytes -> uint8 ``[S, S, 3]`` (the reference
        resize and crop; the model normalises on the device). Raises
        :class:`~dl_vqa_tpu_torch.data.images.UnsupportedImage` for bytes
        the decoder does not take."""
        return decode_image(raw, self.image_size, self.central_fraction,
                            self.decoder, device_index_of(self.device))

    def load_images(self, paths: Sequence[str]) -> np.ndarray:
        """Image files -> uint8 ``[N, S, S, 3]``."""
        return load_image_files(paths, self.image_size,
                                self.central_fraction, self.decoder,
                                device_index_of(self.device))

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
        ``images`` is ``[B, H, W, 3]`` or a list of image paths."""
        if len(images) and isinstance(images[0], (str, os.PathLike)):
            images = self.load_images(images)
        if len(images) != len(questions):
            raise ValueError(f"{len(images)} images for {len(questions)} "
                             "questions")
        encoded, lengths = self.encode_questions(questions)
        probs = self.forward_probs(images, encoded, lengths)
        return [self.top_k_from_probs(row, top_k) for row in probs]

    def predict_dataset_submission(self, dataset, batcher,
                                   image_table=None) -> List[dict]:
        """Official VQA submission entries ``[{'question_id', 'answer'}]``
        over an encoded dataset (argmax answers), in the batcher's order,
        which must be the dataset's (``shuffle=False``). ``image_table``
        (``tpu.device_image_cache``): the store's images on the device; the
        batcher then carries ``image_rows`` (``load_images=False``) and the
        batch's images are gathered on the device."""
        from dl_vqa_tpu_torch.data.pipeline import prefetch_to_device

        answers = []
        offset = 0
        for batch in prefetch_to_device(iter(batcher), self.device, depth=2):
            if image_table is not None:
                images = image_table.index_select(0, batch["image_rows"])
            else:
                images = batch["images"]
            with torch.inference_mode():
                preds = self.model(
                    images, batch["questions"], batch["lengths"],
                    compute_dtype=self.compute_dtype,
                    fused_ops=self.fused_ops).argmax(dim=1).cpu().numpy()
            mask = batch["mask"].cpu().numpy()
            for i in np.flatnonzero(mask):
                answers.append({
                    "question_id": int(dataset.question_ids[offset + i]),
                    "answer": self.answer_by_id.get(int(preds[i]) + 1,
                                                    "<unk>")})
            offset += int(mask.sum())
        return answers

    def export_artifact(self, path: str, batch_sizes: Sequence[int] = (1, 8)
                        ) -> Dict[int, float]:
        """Write an AOT serving artifact of this Predictor to the directory
        ``path``: its forward as one ``torch.export`` program a batch
        bucket, on its device and in its serving mode, the weights as the
        programs' arguments, and the decode metadata (see
        :mod:`dl_vqa_tpu_torch.utils.aot_export`). The numerics are frozen
        at export: the compute dtype, ``fused_ops``, the store mode and any
        calibrated int8 scales are compiled in. Returns the seconds each
        bucket's export took."""
        from dl_vqa_tpu_torch.utils.aot_export import export_artifact

        if self.needs_int8_calibration:
            raise ValueError("the int8 mode has no scales yet: call "
                             "calibrate_int8 before export_artifact")
        model = self.model
        options = {"compute_dtype": self.compute_dtype,
                   "fused_ops": self.fused_ops}

        def forward(params, images, questions, lengths):
            return torch.func.functional_call(
                model, params, (images, questions, lengths), options)

        image = self.model_cfg.image
        return export_artifact(
            path, dict(model.state_dict()), forward,
            batch_sizes=batch_sizes, image_size=self.image_size,
            max_question_length=self.max_question_length, vocab=self.vocab,
            central_fraction=self.central_fraction,
            extra_meta={
                "compute_dtype": str(self.compute_dtype).split(".")[-1],
                "fused_ops": self.fused_ops,
                "store_dtype": image.store_dtype,
                "quant_scales": list(image.quant_scales or ())})


def main(argv=None) -> int:
    from dl_vqa_tpu_torch import config as config_mod

    parser = argparse.ArgumentParser()
    parser.add_argument("--image", action="append", default=[])
    parser.add_argument("--question", action="append", default=[])
    parser.add_argument("--top-k", type=int, default=5)
    parser.add_argument("--submission", default="",
                        help="write official-format answers for the val "
                             "split")
    parser.add_argument("--export-artifact", default="",
                        help="write an AOT serving artifact directory "
                             "(exported forward + weights + metadata; see "
                             "dl_vqa_tpu_torch.utils.aot_export)")
    parser.add_argument("--export-batch-sizes", default="1,8",
                        help="comma-separated batch buckets to export")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs (default: the GPU)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = config_mod.compose("config_eval", overrides=args.overrides)
    predictor = Predictor.from_config(cfg, device=args.device)

    if args.export_artifact:
        sizes = tuple(int(s) for s in args.export_batch_sizes.split(",") if s)
        seconds = predictor.export_artifact(args.export_artifact,
                                            batch_sizes=sizes)
        print(f"wrote serving artifact (batches {sizes}) to "
              f"{args.export_artifact}")
        print(json.dumps({"export_seconds": seconds}))
        return 0

    if args.submission:
        from dl_vqa_tpu_torch.data.dataset import load_or_build_val_dataset
        from dl_vqa_tpu_torch.data.device_cache import plan_image_tables
        from dl_vqa_tpu_torch.data.pipeline import Batcher

        profile = cfg["main"]["full" if cfg["main"]["use_full"] else "small"]
        dataset = load_or_build_val_dataset(cfg, profile, log=print,
                                            device=predictor.device)
        image_table = plan_image_tables(cfg, {"val": dataset},
                                        predictor.device, log=print)["val"]
        batcher = Batcher(dataset, cfg["train"]["batch_size"],
                          load_images=image_table is None)
        entries = predictor.predict_dataset_submission(
            dataset, batcher, image_table=image_table)
        with open(args.submission, "w") as fd:
            json.dump(entries, fd)
        print(f"wrote {len(entries)} answers to {args.submission}")
        return 0

    if args.image:
        questions = args.question or ["what is this?"] * len(args.image)
        for path, question, preds in zip(
                args.image, questions,
                predictor.predict(args.image, questions, args.top_k)):
            print(f"{path} | {question}")
            for answer, prob in preds:
                print(f"  {prob:6.3f}  {answer}")
        return 0

    parser.error("provide --image/--question pairs or --submission")
    return 1


if __name__ == "__main__":
    sys.exit(main())
