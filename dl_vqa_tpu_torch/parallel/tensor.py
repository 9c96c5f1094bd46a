"""Tensor ('model') and expert ('expert') parallelism: what XLA's SPMD
partitioner inserts in the JAX package, written out.

Each rank's modules hold only this rank's shard of a split parameter, as a
plain ``nn.Parameter``, and call the collectives themselves on the groups
of the mesh's axes (``dist.all_reduce`` and ``all_gather``; no DTensor):

* the megatron conjugate pair, :func:`copy_to` (identity forward, the
  gradient all-reduced backward) on the input of a column-parallel layer
  and :func:`reduce_from` (all-reduce forward, identity backward) on the
  partial output of a row-parallel one. Partials are reduced in f32, and
  a row-parallel layer's bias is added once, after the reduction;
* :func:`vocab_lookup`: the embedding rows split over 'model', each rank
  looking up the ids in its rows and the ranks summing (one term and
  zeros: the one-process values);
* :func:`shard_model` / :func:`shard_state` cut the whole one-process
  state into this rank's shards by the placement rules of
  :func:`dl_vqa_tpu_torch.parallel.mesh.param_specs` (in the JAX layout,
  through the weight bridge ``utils/params.py``), and :func:`gather_named`
  puts it back, so a checkpoint is always the one-process npz. The packed
  ``qkv`` of a transformer block is split by heads, not by columns: rank
  ``m`` holds the q, k and v columns of its ``num_heads / model`` heads,
  ``[q_m | k_m | v_m]``, so the attention kernels see a packed local
  ``qkv``; the JAX column split ``P(None, 'model')`` is a placement that XLA
  re-gathers before the attention. A block whose heads the axis does not
  divide keeps ``qkv`` and ``out`` whole on every rank and splits its MLP
  (:func:`~dl_vqa_tpu_torch.parallel.mesh.param_specs`). Under 'stage'
  the stacked ViT blocks split too: a rank keeps the ``L / S`` blocks of
  its stage, and its model's block list holds only those.

Which modules split is read from their shards' shapes
(``set_shards`` of each module of the model); a module whose leaves
replicate (the fallback of the rules) runs as in one process. In one
process, or with no group, every function here is the identity.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dl_vqa_tpu_torch.parallel.mesh import param_specs

__all__ = ["Shard", "copy_to", "reduce_from", "vocab_lookup", "columns",
           "take_columns", "shards_of", "shard_model", "shard_state",
           "gather_named", "sync_replicated_grads", "head_counts"]

# The axes a parameter may be split over, in the order their replicated
# gradients are synced.
_AXES = ("model", "expert", "stage")


class Shard(NamedTuple):
    """This rank's place on one mesh axis (or on the 'expert' x 'model'
    block): the axis's process group, its size and this rank's index."""

    group: object
    size: int
    index: int


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.float().clone()
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        total = x.float().clone()
        dist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``shard``'s group in f32
    (the input of a layer whose ranks each see part of its consumers)."""
    return x if shard is None else _Copy.apply(x, shard.group)


def reduce_from(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``shard``'s group, in f32;
    the gradient passes as it is."""
    return x if shard is None else _Reduce.apply(x, shard.group)


def vocab_lookup(weight: torch.Tensor, ids: torch.Tensor,
                 shard: Optional[Shard]) -> torch.Tensor:
    """``weight[ids]`` for a table whose rows are split over ``shard``:
    rank ``m`` holds rows ``[m * rows, (m + 1) * rows)`` and looks up the
    ids among them, zero elsewhere, and the ranks sum."""
    if shard is None:
        return weight[ids]
    rows = weight.shape[0]
    local = ids - shard.index * rows
    inside = (local >= 0) & (local < rows)
    out = weight[local.clamp(0, rows - 1)]
    out = torch.where(inside[..., None], out, out.new_zeros(()))
    return reduce_from(out, shard)


def columns(shard: Optional[Shard], width: int, parts: int = 1
            ) -> Optional[List[slice]]:
    """This rank's columns of a dim of ``parts`` blocks of ``width`` each
    split over ``shard`` (a '|' fusion's ``[v | q]``: two), as slices of
    the whole dim; None where ``shard`` is None."""
    if shard is None:
        return None
    per = width // shard.size
    return [slice(p * width + shard.index * per,
                  p * width + (shard.index + 1) * per)
            for p in range(parts)]


def take_columns(x: torch.Tensor, cols: Optional[Sequence[slice]],
                 dim: int = -1) -> torch.Tensor:
    """The ``cols`` of ``x`` along ``dim``, in order (``x`` where None)."""
    if cols is None:
        return x
    pieces = [x.narrow(dim, s.start, s.stop - s.start) for s in cols]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def shards_of(mesh, microbatches: int = 0) -> Dict[str, Optional[Shard]]:
    """This rank's :class:`Shard` of 'model', of 'expert' and of the
    'expert' x 'model' block, each None where it has one rank (or in one
    process), under "seq" its
    :class:`~dl_vqa_tpu_torch.parallel.sequence.SequenceContext` and under
    "stage" its :class:`~dl_vqa_tpu_torch.parallel.pipeline.
    PipelineContext` of ``microbatches`` microbatches (0: one a stage),
    None likewise."""
    from dl_vqa_tpu_torch.parallel.pipeline import PipelineContext
    from dl_vqa_tpu_torch.parallel.sequence import SequenceContext

    out = {"model": None, "expert": None, "expert_model": None,
           "seq": SequenceContext.of(mesh), "stage": None}
    if mesh is None or not mesh.distributed:
        return out
    for axis in ("model", "expert"):
        if mesh.size(axis) > 1:
            out[axis] = Shard(mesh.group(axis), mesh.size(axis),
                              mesh.coord(axis))
    if mesh.size("stage") > 1:
        out["stage"] = PipelineContext(
            mesh, microbatches or mesh.size("stage"))
    if mesh.size("expert") > 1 or mesh.size("model") > 1:
        size = mesh.size("expert") * mesh.size("model")
        out["expert_model"] = Shard(
            mesh.expert_model, size,
            mesh.coord("expert") * mesh.size("model") + mesh.coord("model"))
    return out


def head_counts(cfg) -> Dict[str, int]:
    """The head counts of the model's transformer blocks by the top key of
    the JAX tree (``image``, ``text``), for
    :func:`~dl_vqa_tpu_torch.parallel.mesh.param_specs`."""
    out = {}
    if cfg.image.encoder == "vit":
        out["image"] = cfg.image.num_heads
    if cfg.text.encoder == "transformer":
        out["text"] = cfg.text.num_heads
    return out


def _head_aligned(path: str) -> bool:
    return path.endswith(("/qkv/w", "/qkv/b"))


def _map(tree, specs, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map(v, specs[k], fn, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, specs[i], fn, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return fn(prefix, tree, specs)


def _cut(path: str, leaf: np.ndarray, spec, mesh) -> np.ndarray:
    """This rank's block of a whole leaf (JAX layout)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.size(axis), mesh.coord(axis)
        parts = (np.split(leaf, 3, axis=dim)
                 if axis == "model" and _head_aligned(path) else [leaf])
        leaf = np.concatenate([np.split(part, n, axis=dim)[i]
                               for part in parts], axis=dim)
    return np.ascontiguousarray(leaf)


def _join(path: str, leaf: np.ndarray, spec, mesh, device) -> np.ndarray:
    """The whole leaf from every rank's block (a collective over each axis
    the leaf is split on, 'model' before 'expert')."""
    for dim, axis in sorted(enumerate(spec), key=lambda d: d[1] != "model"):
        if axis is None:
            continue
        local = torch.from_numpy(np.ascontiguousarray(leaf)).to(device)
        parts = [torch.empty_like(local) for _ in range(mesh.size(axis))]
        dist.all_gather(parts, local, group=mesh.group(axis))
        parts = [p.cpu().numpy() for p in parts]
        if axis == "model" and _head_aligned(path):
            thirds = [np.split(p, 3, axis=dim) for p in parts]
            leaf = np.concatenate([t[k] for k in range(3) for t in thirds],
                                  axis=dim)
        else:
            leaf = np.concatenate(parts, axis=dim)
    return leaf


def _to_jax(named: Dict[str, torch.Tensor]):
    from dl_vqa_tpu_torch.utils.params import jax_tree_from_named

    return jax_tree_from_named(named)


def _block_free(name: str) -> str:
    """``name`` with a ViT block's index taken out: a stage rank's block
    ``i`` and the whole model's block ``j`` hold the same kinds of
    tensors."""
    return re.sub(r"^image\.blocks\.\d+\.", "image.blocks.#.", name)


def _to_torch(tree, keep) -> Dict[str, np.ndarray]:
    """The tree's tensors under torch names, those of the kinds ``keep``
    holds (every ViT block's where ``keep`` holds some block's)."""
    from dl_vqa_tpu_torch.utils.params import torch_state_from_params

    kinds = {_block_free(name) for name in keep}
    return {name: np.ascontiguousarray(value) for name, value in
            torch_state_from_params(tree).items()
            if _block_free(name) in kinds}


def _cut_named(named: Dict[str, torch.Tensor], specs, mesh
               ) -> Dict[str, np.ndarray]:
    tree = _to_jax(named)
    local = _map(tree, specs, lambda p, leaf, s: _cut(p, leaf, s, mesh))
    return _to_torch(local, named)


def gather_named(named: Dict[str, torch.Tensor], model, mesh
                 ) -> Dict[str, torch.Tensor]:
    """The whole tensors (host, f32) of this rank's shards ``named`` (the
    parameters and buffers of a model cut by :func:`shard_model`, or a
    subset of them, such as the trainable ones' Adam moments), in the
    one-process layout under the same names (under 'stage', every block's):
    a collective over the 'model', 'expert' and 'stage' groups, so every
    rank calls it. A model that was not cut gives ``named`` as it is."""
    specs = getattr(model, "tp_specs", None)
    if specs is None:
        return named
    device = next(iter(named.values())).device
    tree = _to_jax(named)
    whole = _map(tree, specs,
                 lambda p, leaf, s: _join(p, leaf, s, mesh, device))
    return {name: torch.from_numpy(value)
            for name, value in _to_torch(whole, named).items()}


def shard_model(model, mesh, log=None, microbatches: int = 0):
    """Cut ``model`` (a whole :class:`~dl_vqa_tpu_torch.models.vqa.
    VqaNet`, the same on every rank) to this rank's shards on ``mesh``,
    in place, and tell its modules their groups; returns it. The LSTM's
    ``bias_hh`` is folded into ``bias_ih`` on the way (the same sum). A
    mesh whose 'model', 'expert' and 'stage' axes are 1 leaves the
    parameters as they are; with 'seq' above 1 the ViT learns its 'seq'
    group (:mod:`dl_vqa_tpu_torch.parallel.sequence`). Under 'stage' the
    ViT keeps the blocks of this rank's stage and runs them through the
    schedule, ``microbatches`` microbatches a batch (0: one a stage, as
    ``tpu.pipeline_microbatches``); what the JAX package refuses there
    raises its error
    (:func:`~dl_vqa_tpu_torch.parallel.pipeline.check_pipeline`).
    ``log``: where the rules' fallback warning goes."""
    image = model.cfg.image
    if mesh.size("seq") > 1:
        from dl_vqa_tpu_torch.parallel.sequence import (
            check_sequence_parallel)

        check_sequence_parallel(mesh.size("seq"), image.encoder)
        if not mesh.distributed:
            raise ValueError(f"mesh {mesh.shape} splits the tokens: it "
                             "needs a joined process group")
    if mesh.size("stage") > 1:
        from dl_vqa_tpu_torch.parallel.pipeline import check_pipeline

        check_pipeline(model.cfg, mesh.size("stage"))
    if not mesh.splits_state:
        if mesh.size("seq") > 1:
            _set_shards(model, shards_of(mesh))
        return model
    if not mesh.distributed:
        raise ValueError(f"mesh {mesh.shape} splits the parameters: it "
                         "needs a joined process group")
    if getattr(model, "tp_specs", None) is not None:
        raise ValueError("the model is cut already")
    named = model.state_dict()
    tree = _to_jax(named)
    specs = param_specs(tree, dict(mesh.shape), log, head_counts(model.cfg))
    local = _cut_named(named, specs, mesh)
    for name, value in local.items():  # VqaNet holds no buffers
        path, attr = name.rsplit(".", 1)
        module = model.get_submodule(path)
        old = named[name]
        setattr(module, attr, torch.nn.Parameter(
            torch.from_numpy(value).to(device=old.device, dtype=old.dtype),
            requires_grad=getattr(module, attr).requires_grad))
    if mesh.size("stage") > 1:
        # This stage's blocks took the first places of the list.
        blocks = model.image.blocks
        del blocks[image.num_layers // mesh.size("stage"):]
    _set_shards(model, shards_of(mesh, microbatches))
    model.tp_specs = specs
    model.tp_synced = _replicated_over(model, tree, specs, mesh)
    return model


def _set_shards(model, shards) -> None:
    for module in model.modules():
        if hasattr(module, "set_shards"):
            module.set_shards(shards)


def _replicated_over(model, tree, specs, mesh):
    """``[(axis, names)]``: for each of 'model', 'expert' and 'stage' that
    has ranks, the trainable parameters of the cut ``model`` it does not
    split."""
    from dl_vqa_tpu_torch.utils.params import torch_state_from_params

    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    out = []
    for axis in _AXES:
        if mesh.size(axis) < 2:
            continue
        # A leaf of ones where the axis splits it, zeros elsewhere, through
        # the bridge's layout (broadcast views: nothing is allocated).
        marks = torch_state_from_params(_map(
            tree, specs, lambda p, leaf, s: np.broadcast_to(
                np.float32(axis in s), leaf.shape)))
        out.append((axis, [n for n in trainable if not marks[n].flat[0]]))
    return out


def sync_replicated_grads(model, mesh) -> None:
    """Give every rank of a 'model' (of an 'expert', of a 'stage') group
    the gradients of the parameters that axis does not split as its
    coordinate-0 rank has them (one broadcast an axis). The ranks compute
    those gradients alike, but not always to the bit: a library may choose
    another algorithm on each (cuDNN's by the memory free for its
    workspace, and its default f32 backward algorithms are not
    deterministic), and replicated parameters that drift apart are no
    longer one model. Under 'stage' the coordinate-0 rank is the one that
    holds them whole: the gradient of what precedes the blocks (the patch
    embedding, the position table) reaches stage 0 alone. A model that
    was not cut is left as it is."""
    from torch.distributed.tensor import DTensor

    params = dict(model.named_parameters())
    for axis, names in getattr(model, "tp_synced", ()):
        grads = [params[n].grad for n in names
                 if params[n].grad is not None]
        grads = [g.to_local() if isinstance(g, DTensor) else g
                 for g in grads]
        if not grads:
            continue
        group = mesh.group(axis)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.broadcast(flat, src=dist.get_global_rank(group, 0),
                       group=group)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()


def shard_state(state, mesh, log=None, microbatches: int = 0):
    """:func:`shard_model` on ``state.model`` and a fresh Adam over its
    shards, holding this rank's blocks of the whole moments (those the
    state's optimizer held: a restored or stepped state keeps its
    moments); returns ``state``. Call it before
    :func:`~dl_vqa_tpu_torch.parallel.zero.parallelize` and after any
    restore, which loads the whole state. A mesh that splits no
    parameter only tells the model its 'seq' group, if any. Under 'stage'
    a rank holds its blocks' moments alone; ``microbatches`` as
    :func:`shard_model`'s."""
    if not mesh.splits_state:
        shard_model(state.model, mesh, log)
        return state
    from dl_vqa_tpu_torch.train.steps import make_optimizer
    from dl_vqa_tpu_torch.utils.checkpoint import _trainable

    model = state.model
    old = state.optimizer
    trainable = _trainable(model)
    slots = {name: old.state[p] for name, p in trainable.items()
             if p in old.state}
    shard_model(model, mesh, log, microbatches)
    state.optimizer = make_optimizer(model, state.initial_lr)
    if slots:
        if set(slots) != set(trainable):
            raise ValueError("Adam holds moments for some of the "
                             "parameters only")
        local = {key: _cut_named({n: s[key] for n, s in slots.items()},
                                 model.tp_specs, mesh)
                 for key in ("exp_avg", "exp_avg_sq")}
        for name, p in _trainable(model).items():
            state.optimizer.state[p] = {
                "step": slots[name]["step"].clone(),
                **{key: torch.from_numpy(local[key][name]).to(
                    device=p.device, dtype=p.dtype)
                   for key in ("exp_avg", "exp_avg_sq")}}
    state.mesh = mesh
    return state
