"""Read the npz checkpoints that ``dl_vqa_tpu.utils.checkpoint`` writes.

With numpy alone: the file holds flat arrays keyed by the parameter path
joined with ``|`` (``params|text|embedding`` in a full train state,
``text|embedding`` in a bare parameter tree) and a ``__meta__`` JSON blob
(``epoch``, ``model_cfg``, ``max_question_length``, ...). Orbax
directories and writing are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

__all__ = ["load_checkpoint", "load_params"]

_SEP = "|"  # dl_vqa_tpu/utils/checkpoint.py::_SEP


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """``(flat arrays, meta)`` from an npz checkpoint."""
    if os.path.isdir(path) or path.endswith((".orbax", ".pth", ".pt")):
        raise NotImplementedError(
            f"{path!r}: dl_vqa_tpu_torch reads npz checkpoints only")
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data.files else {})
    return flat, meta


def load_params(path: str, with_meta: bool = False):
    """The nested parameter tree of a checkpoint (the ``params`` subtree
    of a full train state), and its meta when ``with_meta``."""
    flat, meta = load_checkpoint(path)
    prefix = "params" + _SEP
    if any(k.startswith(prefix) for k in flat):
        flat = {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return (tree, meta) if with_meta else tree
