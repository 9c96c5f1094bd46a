"""Seeding and config initialisation (the port's copy of
``dl_vqa_tpu/utils/misc.py``)."""

from __future__ import annotations

import random
from typing import Dict

import numpy as np
import torch

from dl_vqa_tpu_torch.config import validate

__all__ = ["set_seed", "init"]


def set_seed(seed: int) -> None:
    """Seed the host RNGs (``random``, numpy) and torch's global
    generators. The model's weights and the dropout masks take their own
    explicit generators; the global ones are seeded for any other draw."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def init(cfg: Dict) -> None:
    """Validate the config."""
    validate(cfg)
