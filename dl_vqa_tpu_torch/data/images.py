"""Image constants and the normalization tail of the image cache.

The port's copy of ``dl_vqa_tpu/data/images.py``'s ``IMAGENET_MEAN``,
``IMAGENET_STD`` and ``normalize_uint8_chw`` (held to them by
``tests/test_torch_copies.py``). The PIL cache builder
(``preprocess_images``) is not ported yet: the port's corpora are rendered
by :mod:`dl_vqa_tpu_torch.data.synthetic` straight into an ``.npy`` store.
"""

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_uint8_chw"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_uint8_chw(u8_nhwc: np.ndarray) -> np.ndarray:
    """uint8 ``[N, H, W, 3]`` (after resize and crop) -> float32
    normalized ``[N, 3, H, W]``."""
    arr = u8_nhwc.astype(np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(arr.transpose(0, 3, 1, 2))
