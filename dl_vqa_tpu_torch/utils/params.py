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
and stacked again on the way back. A MoE tree has
``image.layers.moe.{gate.w [L, D, E], in.{w [L, E, D, F], b [L, E, F]},
out.{w [L, E, F, D], b [L, E, D]}}`` in place of ``mlp_in`` and
``mlp_out``: ``image.blocks.{i}.moe.{gate [E, D], in.weight [E, F, D],
in.bias, out.weight [E, D, F], out.bias}``, each weight's last two axes
swapped to the port's ``[out, in]``. A legacy tree whose ``image.layers``
is a list of per-layer dicts (an npz with ``image|layers|#i|...`` keys)
is stacked first, as the JAX reader migrates it.

The transformer text encoder and the stacked and co attention, which
that exporter refuses too, map under the port's names
(``models/transformer.py``, ``models/fusion.py``): ``text.{in_proj, pos,
final_ln}`` and ``text.layers[i].*`` -> ``text.blocks.{i}.*`` (a list of
blocks, as the JAX tree holds it, each block's leaves as a ViT block's);
``attention.layers[g].{score, update}`` -> ``attention.layers.{g}.*``
(the last glimpse has no ``update``); ``attention.{x_conv, vsum_lin,
tok_lin, tok_out}`` of co-attention as they are named. A tree that lacks
a leaf raises ``ValueError`` naming it.
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
_VIT_MOE_LINEARS = ("qkv", "out")  # and the "moe" group
_CO_LINEARS = ("vsum_lin", "tok_lin", "tok_out")


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _leaf(tree: Mapping, *path, where: str = ""):
    """``tree[path[0]][path[1]]...``; a missing key raises ``ValueError``
    naming the path (after ``where``, the port's name of the subtree)."""
    node = tree
    for i, key in enumerate(path):
        try:
            node = node[key]
        except (KeyError, IndexError, TypeError):
            name = ".".join(str(k) for k in (where,) * bool(where)
                            + path[:i + 1])
            raise ValueError(f"the parameter tree has no {name!r}") from None
    return node


def _linear(dst: Dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _np(_leaf(p, "w", where=prefix)).T
    if "b" in p:
        dst[f"{prefix}.bias"] = _np(p["b"])


def _conv(dst: Dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _np(  # HWIO -> OIHW
        _leaf(p, "w", where=prefix)).transpose(3, 2, 0, 1)
    if "b" in p:
        dst[f"{prefix}.bias"] = _np(p["b"])


def _norm(dst: Dict, prefix: str, p: Mapping) -> None:
    dst[f"{prefix}.weight"] = _np(_leaf(p, "scale", where=prefix))
    dst[f"{prefix}.bias"] = _np(_leaf(p, "bias", where=prefix))


def _stack_layers(layers) -> Dict:
    """A list of per-layer dicts (the ViT tree before its leaves were
    stacked: ``image|layers|#i|...`` in an npz) -> one dict whose leaves
    carry a leading ``[L]`` axis, each ``np.stack`` of the layers' leaves
    (``dl_vqa_tpu/utils/checkpoint.py::_legacy_stacked_leaf``). Raises
    ``ValueError`` naming the layout where the layers are not dicts of one
    structure."""
    def structure(node):
        if isinstance(node, Mapping):
            return {k: structure(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [structure(v) for v in node]
        return None

    kinds = sorted({type(layer).__name__ for layer in layers})
    if not layers or kinds != ["dict"] or any(
            structure(layer) != structure(layers[0]) for layer in layers):
        raise ValueError(
            "image.layers is a list that is not per-layer dicts of one "
            f"structure ({len(layers)} items of {', '.join(kinds) or 'none'}"
            "); expected stacked leaves or such a list")

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack([_np(n) for n in nodes])

    return stack(list(layers))


def _vit_state(state: Dict, image: Mapping) -> None:
    """The ViT image tree under ``image.*`` names: ``layers`` stacked (one
    leaf a parameter, a leading ``[L]`` axis), or a list of per-layer
    dicts, which is stacked first."""
    layers = image["layers"]
    if isinstance(layers, (list, tuple)):
        layers = _stack_layers(layers)
    elif not isinstance(layers, Mapping):
        raise ValueError(
            f"image.layers is a {type(layers).__name__}; expected stacked "
            "leaves or a list of per-layer dicts")
    moe = "moe" in layers
    linears = _VIT_MOE_LINEARS if moe else _VIT_LINEARS
    if set(layers) != set(_VIT_NORMS + linears + ("moe",) * moe):
        raise ValueError(
            "ViT blocks hold ln1, qkv, out, ln2 and either mlp_in and "
            f"mlp_out or moe; the tree's layers hold {sorted(layers)}")
    _linear(state, "image.patch_embed", image["patch_embed"])
    state["image.pos"] = _np(image["pos"])
    _norm(state, "image.final_ln", image["final_ln"])
    for i in range(len(_np(layers["ln1"]["scale"]))):
        for name in _VIT_NORMS + linears:
            layer = {k: v[i] for k, v in layers[name].items()}
            put = _norm if name in _VIT_NORMS else _linear
            put(state, f"image.blocks.{i}.{name}", layer)
        if moe:
            _moe(state, f"image.blocks.{i}.moe", layers["moe"], i)


def _moe(dst: Dict, prefix: str, p: Mapping, i: int) -> None:
    """Layer ``i`` of the stacked MoE group ``p`` under ``prefix``: the
    router ``gate.w [D, E]`` -> ``gate [E, D]``, each expert linear's ``w
    [E, in, out]`` -> ``weight [E, out, in]``, its ``b`` as it is."""
    def get(*path):
        return _np(_leaf(p, *path, where=prefix))[i]

    dst[f"{prefix}.gate"] = get("gate", "w").T
    for name in ("in", "out"):
        dst[f"{prefix}.{name}.weight"] = get(name, "w").transpose(0, 2, 1)
        dst[f"{prefix}.{name}.bias"] = get(name, "b")


def _text_state(state: Dict, text: Mapping) -> None:
    """The LSTM text tree (``lstm_fwd``, ``lstm_bwd``), or the transformer
    text tree (``in_proj``, ``pos``, ``layers`` as a list, ``final_ln``)
    under ``text.*`` names."""
    state["text.embedding.weight"] = _np(
        _leaf(text, "embedding", where="text"))
    if "layers" in text or "pos" in text:
        _linear(state, "text.in_proj", _leaf(text, "in_proj", where="text"))
        state["text.pos"] = _np(_leaf(text, "pos", where="text"))
        _norm(state, "text.final_ln", _leaf(text, "final_ln", where="text"))
        for i in range(len(_leaf(text, "layers", where="text"))):
            for name in _VIT_NORMS + _VIT_LINEARS:
                put = _norm if name in _VIT_NORMS else _linear
                put(state, f"text.blocks.{i}.{name}",
                    _leaf(text, "layers", i, name, where="text"))
        return
    _leaf(text, "lstm_fwd", where="text")  # neither text tree: name it
    for name, suffix in _DIRECTIONS:
        if name not in text:
            continue
        p = text[name]
        state[f"{_LSTM}weight_ih_l0{suffix}"] = _np(
            _leaf(text, name, "w_ih", where="text")).T
        state[f"{_LSTM}weight_hh_l0{suffix}"] = _np(
            _leaf(text, name, "w_hh", where="text")).T
        state[f"{_LSTM}bias_ih_l0{suffix}"] = _np(
            _leaf(text, name, "b", where="text"))
        state[f"{_LSTM}bias_hh_l0{suffix}"] = np.zeros_like(_np(p["b"]))


def _attention_state(state: Dict, attention: Mapping) -> None:
    """The single, stacked (``layers`` as a list of ``{score[,
    update]}``) or co (``vsum_lin``, ``tok_lin``, ``tok_out``) attention
    tree under ``attention.*`` names."""
    def get(*path):
        return _leaf(attention, *path, where="attention")

    _conv(state, "attention.v_conv", get("v_conv"))
    _linear(state, "attention.q_lin", get("q_lin"))
    if "layers" in attention:
        for g, layer in enumerate(attention["layers"]):
            _conv(state, f"attention.layers.{g}.score",
                  get("layers", g, "score"))
            if "update" in layer:
                _linear(state, f"attention.layers.{g}.update",
                        layer["update"])
        return
    _conv(state, "attention.x_conv", get("x_conv"))
    if "vsum_lin" in attention:
        for name in _CO_LINEARS:
            _linear(state, f"attention.{name}", get(name))


def torch_state_from_params(params: Mapping) -> Dict[str, np.ndarray]:
    """A ``dl_vqa_tpu`` parameter tree with the CNN or the dense ViT image
    encoder, the LSTM or the transformer text encoder and the single,
    stacked or co attention -> the state dict of :class:`VqaNet` (numpy
    arrays). A tree that lacks a leaf raises ``ValueError`` naming it."""
    image = params.get("image", {})
    if "blocks" in image:
        raise ValueError("an image tree with 'blocks' is no layout that "
                         "VqaNet maps (the ViT's blocks are 'layers')")
    state: Dict[str, np.ndarray] = {}
    _text_state(state, _leaf(params, "text"))
    if "patch_embed" in image:
        _vit_state(state, image)
    for name, p in sorted(image.items()):
        if name.startswith("conv"):
            _conv(state, f"image.{name}", p)
    _attention_state(state, _leaf(params, "attention"))
    for name in ("lin1", "lin2"):
        _linear(state, f"classifier.{name}",
                _leaf(params, "classifier", name))
    return state


def load_jax_params(model: torch.nn.Module, params: Mapping
                    ) -> torch.nn.Module:
    """Copy a ``dl_vqa_tpu`` parameter tree (numpy or JAX arrays) into
    ``model`` with ``load_state_dict(strict=True)``; returns ``model``. A
    tree with MoE blocks and a model without them raises the JAX model's
    ``ValueError``."""
    state = {
        name: torch.from_numpy(np.array(value, dtype=np.float32))
        for name, value in torch_state_from_params(params).items()
    }
    if (any(".moe." in name for name in state)
            and not any(".moe." in name for name in model.state_dict())):
        from dl_vqa_tpu_torch.ops.moe import MOE_WITHOUT_ROUTING

        raise ValueError(MOE_WITHOUT_ROUTING)
    model.load_state_dict(state, strict=True)
    return model


def jax_tree_from_named(named: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse mapping: tensors under VqaNet's state-dict names (its
    parameters, or their gradients) -> a numpy tree in the JAX layout and
    under the JAX names, lists of layers as lists. A missing ``bias_hh``
    (it has no gradient) counts as zero."""
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

    def norm(prefix):
        return {"scale": get(f"{prefix}.weight"),
                "bias": get(f"{prefix}.bias")}

    def count(prefix):
        return 1 + max((int(n[len(prefix):].split(".")[0]) for n in named
                        if n.startswith(prefix)), default=-1)

    def block(prefix):
        if f"{prefix}.moe.gate" not in named:
            return {name: (norm if name in _VIT_NORMS else linear)(
                f"{prefix}.{name}") for name in _VIT_NORMS + _VIT_LINEARS}
        out = {name: (norm if name in _VIT_NORMS else linear)(
            f"{prefix}.{name}") for name in _VIT_NORMS + _VIT_MOE_LINEARS}
        out["moe"] = {"gate": {"w": get(f"{prefix}.moe.gate").T}}
        for name in ("in", "out"):
            out["moe"][name] = {
                "w": get(f"{prefix}.moe.{name}.weight").transpose(0, 2, 1),
                "b": get(f"{prefix}.moe.{name}.bias")}
        return out

    def stack(nodes):
        if isinstance(nodes[0], Mapping):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    text = {"embedding": get("text.embedding.weight")}
    if "text.pos" in named:
        text.update(in_proj=linear("text.in_proj"), pos=get("text.pos"),
                    final_ln=norm("text.final_ln"),
                    layers=[block(f"text.blocks.{i}")
                            for i in range(count("text.blocks."))])
    for name, suffix in _DIRECTIONS:
        if f"{_LSTM}weight_ih_l0{suffix}" not in named:
            continue
        bias = get(f"{_LSTM}bias_ih_l0{suffix}")
        if f"{_LSTM}bias_hh_l0{suffix}" in named:
            bias = bias + get(f"{_LSTM}bias_hh_l0{suffix}")
        text[name] = {"w_ih": get(f"{_LSTM}weight_ih_l0{suffix}").T,
                      "w_hh": get(f"{_LSTM}weight_hh_l0{suffix}").T,
                      "b": bias}

    if "image.pos" in named:
        layers = stack([block(f"image.blocks.{i}")
                        for i in range(count("image.blocks."))])
        image = {"patch_embed": linear("image.patch_embed"),
                 "pos": get("image.pos"),
                 "final_ln": norm("image.final_ln"),
                 "layers": layers}
    else:
        blocks = sorted({n.split(".")[1] for n in named
                         if n.startswith("image.")})
        image = {block: conv(f"image.{block}") for block in blocks}

    attention = {"v_conv": conv("attention.v_conv"),
                 "q_lin": linear("attention.q_lin")}
    if "attention.layers.0.score.weight" in named:
        attention["layers"] = []
        for g in range(count("attention.layers.")):
            layer = {"score": conv(f"attention.layers.{g}.score")}
            if f"attention.layers.{g}.update.weight" in named:
                layer["update"] = linear(f"attention.layers.{g}.update")
            attention["layers"].append(layer)
    else:
        attention["x_conv"] = conv("attention.x_conv")
        if "attention.vsum_lin.weight" in named:
            attention.update({name: linear(f"attention.{name}")
                              for name in _CO_LINEARS})
    return {
        "text": text,
        "image": image,
        "attention": attention,
        "classifier": {"lin1": linear("classifier.lin1"),
                       "lin2": linear("classifier.lin2")},
    }


def jax_params_from_model(model: torch.nn.Module) -> Dict:
    """``model``'s parameters as a ``dl_vqa_tpu`` parameter tree (numpy)."""
    return jax_tree_from_named(model.state_dict())
