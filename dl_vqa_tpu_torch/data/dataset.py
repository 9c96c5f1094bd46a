"""VQA 2.0 dataset: eager numpy encodings with fixed shapes.

The port's copy of ``dl_vqa_tpu/data/dataset.py``: the same arrays from
the same JSONs (questions zero-padded to the split's longest, the unique
in-vocab answer ids with their annotator counts, the official answer
types, the image-row map), ``answerable_only``, and the npz dataset cache
in the JAX package's format, so each package loads the other's cache.

The image store is the processed feature cache, fp16 ``features [N, 3, H,
W]`` (normalized, CHW) and ``ids [N]``, in one of two containers:

* an h5 file (the JAX package's cache): h5py is imported inside the
  reader only, and a contiguous uncompressed dataset is memory-mapped
  with numpy, as ``_features_view`` does there;
* a directory holding ``features.npy`` and ``ids.npy``, opened with
  ``np.load(mmap_mode="r")`` (what :mod:`dl_vqa_tpu_torch.data.synthetic`
  writes; the card does not assure h5py).

A store of an integer dtype is refused (raw pixels are not a processed
cache), and a cached row map built against another store raises
:class:`StaleImageCacheError` on load. A missing store is built from the
split's JPEG directory (:func:`build_image_store`, through
:func:`dl_vqa_tpu_torch.data.images.preprocess_images`). A dataset made
with ``require_image_cache=False`` (the online JPEG pipeline) has no row
map and reads no store.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Dict

import numpy as np

from dl_vqa_tpu_torch.data import text as vqa_text
from dl_vqa_tpu_torch.data.images import preprocess_images
from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["VQADataset", "StaleImageCacheError", "load_or_build_val_dataset",
           "open_image_store", "build_image_store", "require_image_store",
           "store_ids"]


class StaleImageCacheError(RuntimeError):
    """The persisted dataset cache's image-row map (``h5_rows``) was built
    against a different image store than the one on disk: using it would
    pair questions with the wrong images. Callers rebuild the dataset."""


def _is_npy_store(path: str) -> bool:
    return os.path.isdir(path)


def store_ids(path: str) -> np.ndarray:
    """The ``ids`` array of an image store (either container)."""
    if _is_npy_store(path):
        return np.load(os.path.join(path, "ids.npy"))
    import h5py

    with h5py.File(path, "r") as fd:
        return fd["ids"][()]


def open_image_store(path: str):
    """The ``features`` array ``[N, 3, H, W]`` of an image store, unread:
    the ``.npy`` file memory-mapped, an h5 store through h5py."""
    if _is_npy_store(path):
        return np.load(os.path.join(path, "features.npy"), mmap_mode="r")
    import h5py

    return h5py.File(path, "r")["features"]


def _ids_fingerprint(ids) -> Dict:
    arr = np.ascontiguousarray(np.asarray(ids, dtype=np.int64))
    return {"n": int(arr.shape[0]),
            "sha1": hashlib.sha1(arr.tobytes()).hexdigest()}


class VQADataset:
    """Dense-encoded VQA split.

    Attributes (all fixed-shape numpy):
      questions        int32 [N, Lmax]  zero-padded question token ids
      question_lengths int32 [N]
      answer_indices   int32 [N, Kmax]  1-based answer vocab ids, 0 = pad
      answer_values    int32 [N, Kmax]  annotator counts, 0 = pad
      answer_lengths   int32 [N]        number of unique in-vocab answers
      answer_types     int32 [N]        0 yes/no, 1 number, 2 other
      question_ids     int64 [N]
      image_ids        int64 [N]
      h5_rows          int64 [N]        row of each sample's image in the store
                                        (zeros where ``has_image_rows`` is
                                        False)

    ``require_image_cache=False`` (the online JPEG pipeline, which decodes
    images by id) reads no store: the dataset has no row map and
    ``load_images_*`` refuse it.
    """

    def __init__(
        self,
        data_paths: dict,
        other_paths: dict,
        logger=None,
        answerable_only: bool = False,
        require_image_cache: bool = True,
    ):
        log = logger.write if logger is not None else (lambda *_: None)
        base_path = other_paths["base_path"]

        log("Opening files")
        with open(os.path.join(base_path, data_paths["questions"])) as fd:
            questions_json = json.load(fd)
        with open(os.path.join(base_path, data_paths["answers"])) as fd:
            answers_json = json.load(fd)
        with open(other_paths["vocab_path"]) as fd:
            vocab = json.load(fd)

        log("Checking integrity")
        self._check_integrity(questions_json, answers_json)

        self.vocab = vocab
        self.question_vocab = vocab["question"]
        self.answer_vocab = vocab["answer"]
        self.image_path = data_paths["processed_imgs"]
        self.answerable_only = answerable_only

        log("Preparing and encoding questions")
        tokenized = list(vqa_text.prepare_questions(questions_json))
        self.max_question_length = max(map(len, tokenized)) if tokenized else 0
        n = len(tokenized)
        self.questions = np.zeros((n, self.max_question_length), dtype=np.int32)
        self.question_lengths = np.zeros(n, dtype=np.int32)
        for i, toks in enumerate(tokenized):
            vec, length = vqa_text.encode_question(
                toks, self.question_vocab, self.max_question_length)
            self.questions[i] = vec
            self.question_lengths[i] = length

        log("Preparing and encoding answers")
        encoded = [vqa_text.encode_answers(a, self.answer_vocab)
                   for a in vqa_text.prepare_answers(answers_json)]
        type_codes = {"yes/no": 0, "number": 1}
        self.answer_types = np.array(
            [type_codes.get(ann.get("answer_type", "other"), 2)
             for ann in answers_json["annotations"]], dtype=np.int32)
        self.answer_lengths = np.array([e[2] for e in encoded], dtype=np.int32)
        k_max = max(int(self.answer_lengths.max()), 1) if n else 1
        self.answer_indices = np.zeros((n, k_max), dtype=np.int32)
        self.answer_values = np.zeros((n, k_max), dtype=np.int32)
        for i, (idx, val, k) in enumerate(encoded):
            self.answer_indices[i, :k] = idx
            self.answer_values[i, :k] = val

        log("Indexing images")
        self.question_ids = np.array(
            [q["question_id"] for q in questions_json["questions"]],
            dtype=np.int64)
        self.image_ids = np.array(
            [q["image_id"] for q in questions_json["questions"]],
            dtype=np.int64)
        self.has_image_rows = bool(require_image_cache)
        if require_image_cache:
            ids = store_ids(self.image_path)
            self._h5_ids_meta = _ids_fingerprint(ids)
            row_of = {int(img_id): row for row, img_id in enumerate(ids)}
            self.h5_rows = np.array(
                [row_of[i] for i in self.image_ids.tolist()], dtype=np.int64)
        else:
            self._h5_ids_meta = None
            self.h5_rows = np.zeros(n, dtype=np.int64)

        if answerable_only:
            log("Filtering to answerable-only samples")
            keep = np.nonzero(self.answer_lengths > 0)[0]
            for name in self._ARRAY_FIELDS:
                setattr(self, name, getattr(self, name)[keep])

        self._features = None  # lazy memmap (or h5 dataset) of the store

    @property
    def num_tokens(self) -> int:
        return len(self.question_vocab) + 1

    def __len__(self) -> int:
        return len(self.questions)

    @staticmethod
    def _check_integrity(questions_json: dict, answers_json: dict) -> None:
        qs, anns = questions_json["questions"], answers_json["annotations"]
        assert len(qs) == len(anns), (
            f"Questions/annotations count mismatch: {len(qs)} questions "
            f"vs {len(anns)} annotations"
        )
        assert all(
            q["question_id"] == a["question_id"] for q, a in zip(qs, anns)
        ), "Questions not aligned with answers"
        assert all(
            q["image_id"] == a["image_id"] for q, a in zip(qs, anns)
        ), "Image id of question and answer don't match"
        assert questions_json["data_type"] == answers_json["data_type"], \
            "Mismatched data types"
        assert questions_json["data_subtype"] == answers_json["data_subtype"], \
            "Mismatched data subtypes"

    # -- image access ------------------------------------------------------

    def _features_view(self):
        """The store's features as a zero-copy ``np.memmap``: the ``.npy``
        file always, an h5 dataset when it is contiguous and uncompressed
        (the cache builder's layout); a chunked or compressed h5 dataset
        is read through h5py."""
        if self._features is not None:
            return self._features
        feats = open_image_store(self.image_path)
        if np.issubdtype(np.dtype(feats.dtype), np.integer):
            raise ValueError(
                f"image feature store {self.image_path!r} has integer "
                f"dtype {np.dtype(feats.dtype).name}: this is raw pixel "
                "data, not a processed feature cache. Write the store with "
                "dl_vqa_tpu_torch.data.synthetic.write_image_store (or the "
                "JAX package's preprocess_images)")
        if (not isinstance(feats, np.ndarray) and feats.chunks is None
                and feats.compression is None
                and feats.id.get_offset() is not None):
            feats = np.memmap(self.image_path, dtype=feats.dtype, mode="r",
                              offset=feats.id.get_offset(),
                              shape=feats.shape)
        self._features = feats
        return feats

    @property
    def image_store_nbytes(self) -> int:
        """Bytes of the whole store on the device, where the table is
        always fp16 (2 bytes an element, whatever the store's dtype)."""
        if not self.has_image_rows:
            return 0
        return int(np.prod(self._features_view().shape)) * 2

    @property
    def image_store_rows(self) -> int:
        return int(self._features_view().shape[0])

    def features_nhwc_all(self, dtype=np.float16) -> np.ndarray:
        """The whole store as one ``[N, H, W, 3]`` array: the host side of
        the device image table (``tpu.device_image_cache``)."""
        feats = self._features_view()
        if np.dtype(feats.dtype).itemsize > np.dtype(dtype).itemsize:
            warnings.warn(
                f"image feature store {self.image_path!r} is "
                f"{np.dtype(feats.dtype).name}; downcasting to "
                f"{np.dtype(dtype).name} for the device-resident table "
                "(tpu.device_image_cache=off to keep full precision via "
                "per-batch host transfer)", stacklevel=2)
        return np.ascontiguousarray(
            np.asarray(feats[:], dtype=dtype).transpose(0, 2, 3, 1))

    def load_images_chw(self, sample_indices: np.ndarray,
                        dtype=np.float32) -> np.ndarray:
        """Images of the given sample indices as ``[B, 3, H, W]``."""
        if not self.has_image_rows:
            raise RuntimeError(
                "This dataset was built without an image store "
                "(require_image_cache=False, the online JPEG pipeline of "
                "either package): it has no row map; rebuild it with one.")
        feats = self._features_view()
        rows = self.h5_rows[sample_indices]
        if isinstance(feats, np.ndarray):
            return np.asarray(feats[rows], dtype=dtype)
        # h5py fancy indexing needs sorted unique rows.
        unique_rows, inverse = np.unique(rows, return_inverse=True)
        loaded = np.asarray(feats[unique_rows.tolist()], dtype=dtype)
        return loaded[inverse]

    def load_images_nhwc(self, sample_indices: np.ndarray,
                         dtype=np.float16) -> np.ndarray:
        """Images as ``[B, H, W, 3]`` in the store's fp16; the model casts
        them to the compute dtype on the device."""
        return np.ascontiguousarray(
            self.load_images_chw(sample_indices, dtype).transpose(0, 2, 3, 1))

    # -- persistence: the JAX package's npz cache -----------------------------

    _ARRAY_FIELDS = (
        "questions", "question_lengths", "answer_indices", "answer_values",
        "answer_lengths", "answer_types", "question_ids", "image_ids",
        "h5_rows",
    )

    def save(self, path: str) -> None:
        meta = {
            "vocab": self.vocab,
            "image_path": self.image_path,
            "answerable_only": self.answerable_only,
            "max_question_length": int(self.max_question_length),
            "has_image_rows": self.has_image_rows,
            "h5_ids": self._h5_ids_meta,
        }
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **{f: getattr(self, f) for f in self._ARRAY_FIELDS})

    @classmethod
    def load(cls, path: str) -> "VQADataset":
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as data:
            obj = cls.__new__(cls)
            meta = json.loads(bytes(data["meta"]).decode())
            obj.vocab = meta["vocab"]
            obj.question_vocab = obj.vocab["question"]
            obj.answer_vocab = obj.vocab["answer"]
            obj.image_path = meta["image_path"]
            obj.answerable_only = meta["answerable_only"]
            obj.max_question_length = meta["max_question_length"]
            obj.has_image_rows = meta.get("has_image_rows", True)
            obj._h5_ids_meta = meta.get("h5_ids")
            if (obj.has_image_rows and obj._h5_ids_meta
                    and os.path.exists(obj.image_path)):
                current = _ids_fingerprint(store_ids(obj.image_path))
                if current != obj._h5_ids_meta:
                    raise StaleImageCacheError(
                        f"dataset cache {path!r} was built against a "
                        f"different image store than {obj.image_path!r} "
                        f"(ids fingerprint {obj._h5_ids_meta} vs "
                        f"{current}); rebuild the dataset cache")
            for f in cls._ARRAY_FIELDS:
                if f not in data:
                    raise KeyError(
                        f"Dataset cache {path!r} is missing {f!r}: it was "
                        "written by an older version; delete it to rebuild.")
                setattr(obj, f, data[f])
            obj._features = None
            return obj

    @classmethod
    def cache_path(cls, configured_path: str) -> str:
        """The npz file of a configured cache path (``*.pkl`` in the
        reference's configs)."""
        root, _ = os.path.splitext(configured_path)
        return root + ".npz"


def require_image_store(path: str, image_dir: str) -> None:
    """Raise where the processed image store ``path`` is missing and there
    is no JPEG directory ``image_dir`` to build it from."""
    if not os.path.exists(path) and not os.path.isdir(image_dir):
        raise FileNotFoundError(
            f"image store {path!r} does not exist, and there is no image "
            f"directory {image_dir!r} to build it from (preprocess_images "
            "reads the COCO JPEGs there): point processed_imgs at a store "
            "or imgs at the JPEGs")


def build_image_store(cfg, profile, split: str, log=None,
                      device=DEFAULT_DEVICE) -> None:
    """Build ``profile[split]``'s image store from its JPEG directory where
    the store is missing (``tpu.image_builder_backend``; ``auto`` decodes
    with the decoder of ``device``), as the JAX entry points do."""
    log = log or (lambda *_: None)
    processed = profile[split]["processed_imgs"]
    image_dir = os.path.join(profile["paths"]["base_path"],
                             profile[split]["imgs"])
    require_image_store(processed, image_dir)
    if os.path.exists(processed):
        return
    log(f"Processing {split} images -> {processed}")
    preprocess_images(
        other_paths=profile["paths"], data_paths=profile[split],
        image_size=cfg["train"]["image_size"],
        central_fraction=cfg["train"]["central_fraction"],
        processed_path=processed, log=log,
        backend=cfg["tpu"]["image_builder_backend"], device=device)


def load_or_build_val_dataset(cfg, profile, logger=None, log=None,
                              require_image_cache=True,
                              device=DEFAULT_DEVICE):
    """The val dataset of the eval entry points: its image store built
    where it is missing (when required), the dataset loaded from its npz
    cache, rebuilt when the cache is from an older version, was built
    against another image store, or has no image rows and they are
    required."""
    log = log or (lambda *_: None)
    if require_image_cache:
        build_image_store(cfg, profile, "val_paths", log=log, device=device)
    cache = VQADataset.cache_path(profile["val_paths"]["vqaDataset"])
    dataset = None
    if os.path.exists(cache):
        try:
            dataset = VQADataset.load(cache)
        except (KeyError, StaleImageCacheError) as e:
            log(f"Rebuilding stale cache {cache}: {e}")
            dataset = None
        if (dataset is not None and require_image_cache
                and not dataset.has_image_rows):
            dataset = None
    if dataset is None:
        dataset = VQADataset(
            data_paths=profile["val_paths"], other_paths=profile["paths"],
            logger=logger, answerable_only=False,
            require_image_cache=require_image_cache)
        dataset.save(cache)
    return dataset
