"""npz checkpoints in the layout ``dl_vqa_tpu.utils.checkpoint`` writes.

With numpy alone: the file holds flat arrays keyed by the JAX path joined
with ``|`` and a ``__meta__`` JSON blob (``epoch``, ``model_cfg`` as the
dataclass dict, ``max_question_length``, resume progress, ...). A train
state is

* ``params|…`` — the parameter tree in the JAX layout and names
  (:mod:`dl_vqa_tpu_torch.utils.params`: conv HWIO, linear ``[in, out]``,
  the LSTM's one fused bias ``b = bias_ih + bias_hh``);
* ``opt_state|#0|count``, ``opt_state|#0|mu|…``, ``opt_state|#0|nu|…``,
  ``opt_state|#1|count`` — optax's Adam and schedule states: torch Adam's
  ``exp_avg`` / ``exp_avg_sq`` under the same names and layouts as the
  parameters (the fused bias's moments are ``bias_ih``'s; the constant
  ``bias_hh`` has none), its per-parameter ``step`` as the int32 count;
* ``step`` — int32, the updates done.

So the JAX package restores the port's checkpoints into its own train
state and the port restores the JAX package's. Orbax directories are not
read or written (see ROADMAP, "Leave behind").
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "save_checkpoint_async", "save_params",
           "wait_for_async_saves", "host_snapshot", "load_checkpoint",
           "load_params", "restore_state", "restore_state_meta"]

_SEP = "|"  # dl_vqa_tpu/utils/checkpoint.py::_SEP


def _refuse_orbax(path: str) -> None:
    if path.endswith(".orbax") or os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r}: dl_vqa_tpu_torch reads and writes npz checkpoints "
            "only (the Orbax backend is left behind, see ROADMAP)")


def _flatten_tree(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Leaves under their JAX paths: dict keys as they are, list items as
    ``#i`` (``dl_vqa_tpu/utils/checkpoint.py::_path_str``)."""
    items = (tree.items() if isinstance(tree, dict)
             else ((f"#{i}", v) for i, v in enumerate(tree)))
    for key, value in items:
        name = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(value, (dict, list)):
            _flatten_tree(value, name, out)
        else:
            out[name] = np.asarray(value)


def _lists(node):
    """A dict whose keys are all ``#0 .. #n-1`` back into a list."""
    if not isinstance(node, dict):
        return node
    node = {key: _lists(value) for key, value in node.items()}
    if node and set(node) == {f"#{i}" for i in range(len(node))}:
        return [node[f"#{i}"] for i in range(len(node))]
    return node


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _lists(tree)


def _trainable(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    return {name: p for name, p in model.named_parameters()
            if p.requires_grad}


def host_snapshot(state) -> Dict[str, np.ndarray]:
    """A train state as the flat JAX-layout arrays of its checkpoint,
    copied to host memory now: later in-place updates of the state do not
    reach the snapshot. Under ZeRO the parameters and moments are gathered
    from every rank into the one-process layout
    (:func:`dl_vqa_tpu_torch.parallel.zero.full_state`): every rank calls
    this, and the coordinator writes what it returns."""
    from dl_vqa_tpu_torch.parallel.zero import full_state
    from dl_vqa_tpu_torch.utils.params import jax_tree_from_named

    named, moments, count = full_state(state)
    flat: Dict[str, np.ndarray] = {}
    _flatten_tree(jax_tree_from_named(named), "params", flat)
    count = np.asarray(count, dtype=np.int32)
    flat["opt_state|#0|count"] = count
    _flatten_tree(jax_tree_from_named(moments["exp_avg"]), "opt_state|#0|mu",
                  flat)
    _flatten_tree(jax_tree_from_named(moments["exp_avg_sq"]),
                  "opt_state|#0|nu", flat)
    flat["opt_state|#1|count"] = count.copy()
    flat["step"] = np.asarray(state.step, dtype=np.int32)
    return flat


def _write(path: str, flat: Dict[str, np.ndarray], meta: Dict) -> None:
    payload = dict(flat)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez(path, **payload)
    # np.savez appends .npz; keep the requested name.
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        os.replace(path + ".npz", path)


def _meta(epoch, model_cfg, extra_meta) -> Dict:
    meta = {"epoch": epoch}
    if model_cfg is not None:
        meta["model_cfg"] = dataclasses.asdict(model_cfg)
    if extra_meta:
        meta.update(extra_meta)
    return meta


def save_checkpoint(path: str, state, epoch: Optional[int] = None,
                    model_cfg=None, extra_meta: Optional[Dict] = None
                    ) -> None:
    """Write ``state`` (a :class:`~dl_vqa_tpu_torch.train.state.
    TrainState`) to ``path`` in the JAX npz layout. ``extra_meta`` merges
    JSON-serialisable entries into the metadata."""
    _refuse_orbax(path)
    _write(path, host_snapshot(state), _meta(epoch, model_cfg, extra_meta))


def save_params(path: str, model: torch.nn.Module,
                epoch: Optional[int] = None, model_cfg=None,
                extra_meta: Optional[Dict] = None) -> None:
    """Write ``model``'s parameters alone, as the bare JAX-layout tree that
    ``save_checkpoint`` of the JAX package writes for a params tree (no
    optimizer state), with the same metadata; both packages'
    ``load_params`` read it."""
    from dl_vqa_tpu_torch.utils.params import jax_params_from_model

    _refuse_orbax(path)
    flat: Dict[str, np.ndarray] = {}
    _flatten_tree(jax_params_from_model(model), "", flat)
    _write(path, flat, _meta(epoch, model_cfg, extra_meta))


_async_executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pending_save: Optional[concurrent.futures.Future] = None


def save_checkpoint_async(path: str, state, epoch: Optional[int] = None,
                          model_cfg=None,
                          extra_meta: Optional[Dict] = None) -> None:
    """:func:`save_checkpoint` off the training path: every tensor is
    copied to host memory before this returns (the step updates the
    parameters and moments in place), then a background thread writes the
    file. A second call first joins the write in flight, so one file is
    never written by two threads."""
    global _async_executor, _pending_save
    _refuse_orbax(path)
    if _async_executor is None:
        _async_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt")
    if _pending_save is not None:
        _pending_save.result()  # raises a previous write's error
    snapshot = host_snapshot(state)
    _pending_save = _async_executor.submit(
        _write, path, snapshot, _meta(epoch, model_cfg, extra_meta))


def wait_for_async_saves() -> None:
    """Block until the async checkpoint write in flight, if any, ends."""
    global _pending_save
    if _pending_save is not None:
        pending, _pending_save = _pending_save, None
        pending.result()


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """``(flat arrays, meta)`` from an npz checkpoint."""
    _refuse_orbax(path)
    if path.endswith((".pth", ".pt")):
        raise ValueError(f"{path!r} is a torch blob, not an npz checkpoint; "
                         "load_params reads its parameters")
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__meta__"}
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data.files else {})
    return flat, meta


def _subtree(flat: Dict[str, np.ndarray], prefix: str) -> Dict:
    head = prefix + _SEP
    return _nest({k[len(head):]: v for k, v in flat.items()
                  if k.startswith(head)})


def restore_state_meta(state, path: str):
    """Load a full train state from ``path`` into ``state`` (parameters
    and Adam moments in place, on the model's device) and return
    ``(state, meta)``, meta being the checkpoint's whole metadata (rolling
    checkpoints carry resume progress there)."""
    from dl_vqa_tpu_torch.utils.params import (
        load_jax_params, torch_state_from_params)

    wait_for_async_saves()  # a write of this process may be in flight
    flat, meta = load_checkpoint(path)
    missing = [k for k in ("opt_state|#0|count", "step") if k not in flat]
    if missing or not any(k.startswith("params" + _SEP) for k in flat):
        raise KeyError(f"{path!r} holds no full train state (missing "
                       f"{missing or 'params'}); load_params reads bare "
                       "parameters")
    load_jax_params(state.model, _subtree(flat, "params"))
    count = int(flat["opt_state|#0|count"])
    mu = torch_state_from_params(_subtree(flat, "opt_state|#0|mu"))
    nu = torch_state_from_params(_subtree(flat, "opt_state|#0|nu"))
    for name, p in _trainable(state.model).items():
        slot = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for key, source in (("exp_avg", mu), ("exp_avg_sq", nu)):
            value = torch.from_numpy(np.ascontiguousarray(source[name]))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"Shape mismatch for the moment {key} of {name!r}: "
                    f"checkpoint {tuple(value.shape)} vs model "
                    f"{tuple(p.shape)}")
            slot[key] = value.to(device=p.device, dtype=p.dtype)
        state.optimizer.state[p] = slot
    state.step = int(flat["step"])
    return state, meta


def restore_state(state, path: str):
    """:func:`restore_state_meta`, returning ``(state, epoch)``."""
    state, meta = restore_state_meta(state, path)
    return state, meta.get("epoch")


def load_params(path: str, with_meta: bool = False):
    """The nested parameter tree (JAX layout) of a checkpoint: the
    ``params`` subtree of a full train state, a bare parameter tree, or a
    reference ``.pth`` blob (whose meta is empty); and the meta when
    ``with_meta``."""
    if path.endswith((".pth", ".pt")):
        from dl_vqa_tpu_torch.utils.torch_import import load_torch_checkpoint

        params = load_torch_checkpoint(path)["params"]
        return (params, {}) if with_meta else params
    flat, meta = load_checkpoint(path)
    if any(k.startswith("params" + _SEP) for k in flat):
        tree = _subtree(flat, "params")
    else:
        tree = _nest(flat)
    return (tree, meta) if with_meta else tree
