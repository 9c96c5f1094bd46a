"""Import reference PyTorch checkpoints (``model.pth``) as a JAX-layout
parameter tree.

The port's copy of ``dl_vqa_tpu/utils/torch_import.py`` (held to it by
``tests/test_torch_copies.py``): the reference saves ``{'epoch',
'model_state', 'optimizer_state'}`` with ``torch.save``; its
``model_state`` maps onto the JAX layout (linear ``[out, in]`` -> ``[in,
out]``, conv OIHW -> HWIO, LSTM ``weight_ih_l0`` ``[4H, E]`` -> ``w_ih``
``[E, 4H]``, the two LSTM biases summed into one ``b``; gate order i, f,
g, o on both sides), which :func:`dl_vqa_tpu_torch.utils.params.
load_jax_params` then loads into a ``VqaNet``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["params_from_torch_state", "load_torch_blob",
           "load_torch_checkpoint"]


def _to_np(tensor) -> np.ndarray:
    return np.asarray(tensor.detach().cpu().numpy(), dtype=np.float32)


def _linear(state: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {"w": _to_np(state[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in state:
        out["b"] = _to_np(state[f"{prefix}.bias"])
    return out


def _conv(state: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out = {"w": _to_np(state[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in state:
        out["b"] = _to_np(state[f"{prefix}.bias"])
    return out


def _lstm_direction(state: Dict, suffix: str) -> Dict[str, np.ndarray]:
    return {
        "w_ih": _to_np(state[f"text.lstm.weight_ih_l0{suffix}"]).T,
        "w_hh": _to_np(state[f"text.lstm.weight_hh_l0{suffix}"]).T,
        "b": _to_np(state[f"text.lstm.bias_ih_l0{suffix}"])
        + _to_np(state[f"text.lstm.bias_hh_l0{suffix}"]),
    }


def params_from_torch_state(state: Dict) -> Dict:
    """Map a reference ``model_state`` dict to a JAX-layout param tree."""
    params: Dict = {
        "text": {"embedding": _to_np(state["text.embedding.weight"])},
        "image": {},
        "attention": {
            "v_conv": _conv(state, "attention.v_conv"),
            "q_lin": _linear(state, "attention.q_lin"),
            "x_conv": _conv(state, "attention.x_conv"),
        },
        "classifier": {
            "lin1": _linear(state, "classifier.lin1"),
            "lin2": _linear(state, "classifier.lin2"),
        },
    }
    params["text"]["lstm_fwd"] = _lstm_direction(state, "")
    if "text.lstm.weight_ih_l0_reverse" in state:
        params["text"]["lstm_bwd"] = _lstm_direction(state, "_reverse")

    block = 0
    while f"image.conv{block}.weight" in state:
        params["image"][f"conv{block}"] = _conv(state, f"image.conv{block}")
        block += 1
    return params


def load_torch_blob(path: str):
    """Load a reference ``.pth`` and split it into ``(state_dict, meta)``;
    a bare ``state_dict`` file gives an empty ``meta``."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state" in blob:
        meta = {
            k: v for k, v in blob.items()
            if k not in ("model_state", "optimizer_state")
            and not hasattr(v, "keys")
        }
        return blob["model_state"], meta
    return blob, {}


def load_torch_checkpoint(path: str) -> Dict:
    """Load a reference ``model.pth``: ``{"params", "epoch"}``."""
    state, meta = load_torch_blob(path)
    return {
        "params": params_from_torch_state(state),
        "epoch": meta.get("epoch"),
    }
