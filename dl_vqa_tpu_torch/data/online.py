"""The online image pipeline: JPEGs decoded by image id as batches are
made, instead of a processed image store.

The port's counterpart of ``dl_vqa_tpu/data/online.py`` and
``data/native_loader.py``. Each batch's images are decoded on host
threads into uint8 ``[B, S, S, 3]`` (half the bytes of the fp16 store),
staged through :func:`dl_vqa_tpu_torch.data.pipeline.prefetch_to_device`'s
pinned memory as they are, and normalised by the model on the device
(:func:`dl_vqa_tpu_torch.models.layers.normalize_images`). Decoding batch
N + 1 on the prefetch thread overlaps the step of batch N.

:class:`JpegLoader` stands in for both JAX loaders: with ``decoder=None``
it decodes with :func:`~dl_vqa_tpu_torch.data.images.decoder_for` its
device (``tpu.online_images=true``): the exact decoder, PIL's pixels as
the JAX package's PIL ``JpegLoader`` gives them, its last stages on the
card (or in their plain versions on a CPU device); with
``decoder="libjpeg"`` with libjpeg only (``tpu.native_loader=true``, the
JAX package's ``NativeJpegLoader``). The JAX native loader rescues what
libjpeg cannot decode through PIL; the port does not import PIL, and a
file that fails raises, naming it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from dl_vqa_tpu_torch.data.images import (
    coco_id_from_filename, decode_image_files, decoder_for, device_index_of,
    list_jpgs)
from dl_vqa_tpu_torch.data.pipeline import Batcher
from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["JpegLoader", "OnlineBatcher"]


class JpegLoader:
    """Maps COCO image ids to the ``*.jpg`` files of ``image_dir`` and
    decodes them to uint8 ``[S, S, 3]`` with the reference resize and crop,
    on ``num_threads`` threads (0: ``os.cpu_count()``)."""

    def __init__(self, image_dir: str, image_size: int,
                 central_fraction: float, num_threads: int = 8,
                 decoder=None, device=DEFAULT_DEVICE):
        self.image_dir = image_dir
        self.image_size = image_size
        self.central_fraction = central_fraction
        self.num_threads = num_threads
        self.decoder = decoder or decoder_for(device)
        self.device_index = (device_index_of(device)
                             if self.decoder != "libjpeg" else -1)
        self._path_by_id: Dict[int, str] = {
            coco_id_from_filename(f): os.path.join(image_dir, f)
            for f in list_jpgs(image_dir)}

    def path_of(self, image_id) -> str:
        try:
            return self._path_by_id[int(image_id)]
        except KeyError:
            raise KeyError(f"image id {int(image_id)} has no *.jpg in "
                           f"{self.image_dir!r}") from None

    def load_batch(self, image_ids: np.ndarray) -> np.ndarray:
        """Decode a batch -> uint8 ``[B, S, S, 3]`` in the ids' order."""
        return decode_image_files(
            [self.path_of(i) for i in image_ids], self.image_size,
            self.central_fraction, self.decoder, self.num_threads,
            self.device_index)


class OnlineBatcher(Batcher):
    """A :class:`~dl_vqa_tpu_torch.data.pipeline.Batcher` whose batches
    carry the images of ``loader`` (uint8 NHWC) in place of the sample
    indices, and no ``image_rows``: the shuffle, padding, mask and the
    order from ``(seed, epoch)`` are the Batcher's."""

    def __init__(self, dataset, batch_size: int, loader: JpegLoader,
                 shuffle: bool = False, seed: int = 0, process_slice=None):
        super().__init__(dataset, batch_size, shuffle=shuffle, seed=seed,
                         load_images=False, process_slice=process_slice)
        self.loader = loader

    def _finalize_batch(self, batch: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        batch.pop("image_rows", None)
        batch["images"] = self.loader.load_batch(
            self.dataset.image_ids[batch.pop("indices")])
        return batch


def loader_from_config(cfg: dict, profile: dict, split: str,
                       device=DEFAULT_DEVICE, log=None) -> JpegLoader:
    """The entry points' loader of ``profile[split]``'s JPEG directory:
    ``cfg['main']['num_workers']`` threads, libjpeg where
    ``tpu.native_loader`` is set, else the decoder of ``device`` (the
    exact decoder); the decoder in use goes to ``log``."""
    image_dir = os.path.join(profile["paths"]["base_path"],
                             profile[split]["imgs"])
    loader = JpegLoader(
        image_dir, image_size=cfg["train"]["image_size"],
        central_fraction=cfg["train"]["central_fraction"],
        num_threads=cfg["main"]["num_workers"],
        decoder="libjpeg" if cfg["tpu"]["native_loader"] else None,
        device=device)
    if log is not None:
        log(f"Online images: {split} from {image_dir} by {loader.decoder} "
            f"on {loader.num_threads} threads")
    return loader
