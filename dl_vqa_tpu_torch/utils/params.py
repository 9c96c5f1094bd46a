"""Weight bridge: JAX parameter trees into the port's VqaNet.

The layout mapping is ``dl_vqa_tpu.utils.torch_export.
torch_state_from_params`` (HWIO -> OIHW, ``[in, out]`` -> ``[out, in]``,
the fused LSTM bias -> ``bias_ih = b``, ``bias_hh = 0``), reused rather
than copied; that module needs numpy only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["load_jax_params"]


def load_jax_params(model: torch.nn.Module, params: Dict) -> torch.nn.Module:
    """Copy a ``dl_vqa_tpu`` parameter tree (numpy or JAX arrays) into
    ``model`` with ``load_state_dict(strict=True)``; returns ``model``."""
    from dl_vqa_tpu.utils.torch_export import torch_state_from_params

    state = {
        name: torch.from_numpy(np.array(value, dtype=np.float32))
        for name, value in torch_state_from_params(params).items()
    }
    model.load_state_dict(state, strict=True)
    return model
