"""Image constants (the port's copy of ``dl_vqa_tpu/data/images.py``'s)."""

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
