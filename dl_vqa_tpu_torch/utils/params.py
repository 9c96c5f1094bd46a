"""Weight bridge between JAX parameter trees and the port's VqaNet.

The layout mapping is the port's own copy of ``dl_vqa_tpu/utils/
torch_export.py::torch_state_from_params`` (HWIO -> OIHW, ``[in, out]``
-> ``[out, in]``, the fused LSTM bias -> ``bias_ih = b``, ``bias_hh =
0``) and its inverse (``b = bias_ih + bias_hh``), with numpy alone.

The ViT image encoder, which that exporter refuses, maps as follows (the
state-dict names are the port's own, ``models/vit.py``):
``image.patch_embed.{w [P*P*3, D], b}`` -> ``image.patch_embed.{weight
[D, P*P*3], bias}``; ``image.pos`` as it is; ``image.final_ln.{scale,
bias}`` -> ``image.final_ln.{weight, bias}``; and ``image.layers.{ln1,
ln2}.{scale, bias}``, ``image.layers.{qkv, out, mlp_in, mlp_out}.{w, b}``,
every leaf with a leading ``[L]`` axis, -> ``image.blocks.{i}.*`` for
``i < L``, unstacked (and the linear weights transposed) on the way in
and stacked again on the way back.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["torch_state_from_params", "load_jax_params",
           "jax_tree_from_named", "jax_params_from_model"]

_LSTM = "text.lstm."
_DIRECTIONS = (("lstm_fwd", ""), ("lstm_bwd", "_reverse"))
_VIT_NORMS = ("ln1", "ln2")
_VIT_LINEARS = ("qkv", "out", "mlp_in", "mlp_out")


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(dst: Dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _np(p["w"]).T
    if "b" in p:
        dst[f"{prefix}.bias"] = _np(p["b"])


def _conv(dst: Dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _np(p["w"]).transpose(3, 2, 0, 1)  # HWIO->OIHW
    if "b" in p:
        dst[f"{prefix}.bias"] = _np(p["b"])


def _norm(dst: Dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _np(p["scale"])
    dst[f"{prefix}.bias"] = _np(p["bias"])


def _vit_state(state: Dict, image: Mapping) -> None:
    """The ViT image tree (stacked ``layers``) under ``image.*`` names."""
    layers = image["layers"]
    if set(layers) != set(_VIT_NORMS + _VIT_LINEARS):
        raise ValueError(
            "only dense ViT blocks (ln1, qkv, out, ln2, mlp_in, mlp_out) "
            f"are ported; the tree's layers hold {sorted(layers)}")
    _linear(state, "image.patch_embed", image["patch_embed"])
    state["image.pos"] = _np(image["pos"])
    _norm(state, "image.final_ln", image["final_ln"])
    for i in range(len(_np(layers["ln1"]["scale"]))):
        for name in _VIT_NORMS + _VIT_LINEARS:
            layer = {k: v[i] for k, v in layers[name].items()}
            put = _norm if name in _VIT_NORMS else _linear
            put(state, f"image.blocks.{i}.{name}", layer)


def torch_state_from_params(params: Mapping) -> Dict[str, np.ndarray]:
    """A ``dl_vqa_tpu`` parameter tree with the CNN or the dense ViT image
    encoder, the LSTM text encoder and single attention -> the state dict
    of :class:`VqaNet` (numpy arrays)."""
    image = params.get("image", {})
    if ("blocks" in image
            or "lstm_fwd" not in params.get("text", {})
            or "v_conv" not in params.get("attention", {})):
        raise ValueError(
            "only the CNN or dense-ViT / LSTM / single-attention family "
            "maps onto VqaNet's state dict; the transformer-text and "
            "stacked or co-attention variants are not ported")
    state = {"text.embedding.weight": _np(params["text"]["embedding"])}
    for name, suffix in _DIRECTIONS:
        if name not in params["text"]:
            continue
        p = params["text"][name]
        state[f"{_LSTM}weight_ih_l0{suffix}"] = _np(p["w_ih"]).T
        state[f"{_LSTM}weight_hh_l0{suffix}"] = _np(p["w_hh"]).T
        state[f"{_LSTM}bias_ih_l0{suffix}"] = _np(p["b"])
        state[f"{_LSTM}bias_hh_l0{suffix}"] = np.zeros_like(_np(p["b"]))
    if "patch_embed" in image:
        _vit_state(state, image)
    for name, p in sorted(image.items()):
        if name.startswith("conv"):
            _conv(state, f"image.{name}", p)
    _conv(state, "attention.v_conv", params["attention"]["v_conv"])
    _linear(state, "attention.q_lin", params["attention"]["q_lin"])
    _conv(state, "attention.x_conv", params["attention"]["x_conv"])
    _linear(state, "classifier.lin1", params["classifier"]["lin1"])
    _linear(state, "classifier.lin2", params["classifier"]["lin2"])
    return state


def load_jax_params(model: torch.nn.Module, params: Mapping
                    ) -> torch.nn.Module:
    """Copy a ``dl_vqa_tpu`` parameter tree (numpy or JAX arrays) into
    ``model`` with ``load_state_dict(strict=True)``; returns ``model``."""
    state = {
        name: torch.from_numpy(np.array(value, dtype=np.float32))
        for name, value in torch_state_from_params(params).items()
    }
    model.load_state_dict(state, strict=True)
    return model


def jax_tree_from_named(named: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse mapping: tensors under VqaNet's state-dict names (its
    parameters, or their gradients) -> a numpy tree in the JAX layout and
    under the JAX names. A missing ``bias_hh`` (it has no gradient) counts
    as zero."""
    def get(name):
        return named[name].detach().cpu().numpy().astype(np.float32)

    def linear(prefix):
        out = {"w": get(f"{prefix}.weight").T}
        if f"{prefix}.bias" in named:
            out["b"] = get(f"{prefix}.bias")
        return out

    def conv(prefix):
        out = {"w": get(f"{prefix}.weight").transpose(2, 3, 1, 0)}  # ->HWIO
        if f"{prefix}.bias" in named:
            out["b"] = get(f"{prefix}.bias")
        return out

    text = {"embedding": get("text.embedding.weight")}
    for name, suffix in _DIRECTIONS:
        if f"{_LSTM}weight_ih_l0{suffix}" not in named:
            continue
        bias = get(f"{_LSTM}bias_ih_l0{suffix}")
        if f"{_LSTM}bias_hh_l0{suffix}" in named:
            bias = bias + get(f"{_LSTM}bias_hh_l0{suffix}")
        text[name] = {"w_ih": get(f"{_LSTM}weight_ih_l0{suffix}").T,
                      "w_hh": get(f"{_LSTM}weight_hh_l0{suffix}").T,
                      "b": bias}
    def norm(prefix):
        return {"scale": get(f"{prefix}.weight"),
                "bias": get(f"{prefix}.bias")}

    if "image.pos" in named:
        count = 1 + max(int(n.split(".")[2]) for n in named
                        if n.startswith("image.blocks."))
        layers = {}
        for name in _VIT_NORMS + _VIT_LINEARS:
            take = norm if name in _VIT_NORMS else linear
            per_layer = [take(f"image.blocks.{i}.{name}")
                         for i in range(count)]
            layers[name] = {leaf: np.stack([p[leaf] for p in per_layer])
                            for leaf in per_layer[0]}
        image = {"patch_embed": linear("image.patch_embed"),
                 "pos": get("image.pos"),
                 "final_ln": norm("image.final_ln"),
                 "layers": layers}
    else:
        blocks = sorted({n.split(".")[1] for n in named
                         if n.startswith("image.")})
        image = {block: conv(f"image.{block}") for block in blocks}
    return {
        "text": text,
        "image": image,
        "attention": {"v_conv": conv("attention.v_conv"),
                      "q_lin": linear("attention.q_lin"),
                      "x_conv": conv("attention.x_conv")},
        "classifier": {"lin1": linear("classifier.lin1"),
                       "lin2": linear("classifier.lin2")},
    }


def jax_params_from_model(model: torch.nn.Module) -> Dict:
    """``model``'s parameters as a ``dl_vqa_tpu`` parameter tree (numpy)."""
    return jax_tree_from_named(model.state_dict())
