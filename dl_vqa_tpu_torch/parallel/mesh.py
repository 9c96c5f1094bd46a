"""The device mesh and the tensor-parallel placement rules.

The port's counterpart of ``dl_vqa_tpu/parallel/mesh.py``. The JAX mesh
is a grid of chips with the axes ('data'[, 'seq'][, 'expert'], 'model'[,
'stage']); the port runs one process per GPU, so its mesh is a grid of
ranks with the same names in the same order, 'data' outermost (a
``torch.distributed.device_mesh.DeviceMesh`` once a process group is
joined): rank ``r`` sits at ``(d, [s,] [e,] m[, p])`` of ``arange(world).
reshape(shape)``. Every axis may exceed 1: 'seq' splits the ViT's tokens
(:mod:`dl_vqa_tpu_torch.parallel.sequence`), 'stage' its blocks
(:mod:`dl_vqa_tpu_torch.parallel.pipeline`); 'seq' with 'stage' raises
the JAX model's error.

The placement rules (:func:`spec_for`, :func:`param_specs`) are the JAX
package's, by parameter path of the JAX tree, with its fallback to
replication where a dim does not divide its axis and its warning for a
large leaf that falls back; the stacked ViT block leaves take a leading
'stage' split. The port splits a transformer block's packed ``qkv`` by
heads where JAX splits its columns, so a block whose heads the 'model'
axis does not divide keeps its ``qkv`` and ``out`` whole (the rules'
fallback, warned of in the same words) and splits its MLP. Where JAX
places a leaf and lets the SPMD partitioner insert the collectives, the
port cuts each rank's shard out of the whole state
(:mod:`dl_vqa_tpu_torch.parallel.tensor`) and its modules call the
collectives themselves. The batch is split over 'data' only: a rank holds
the rows of its 'data' coordinate
(:func:`~dl_vqa_tpu_torch.parallel.multihost.process_batch_slice`), so the
ranks of one 'seq' x 'expert' x 'model' group feed the same rows, as JAX's
``P('data')`` places a batch; :mod:`dl_vqa_tpu_torch.parallel.zero` splits
the train state over 'data' by wrapping the model (ZeRO,
``tpu.zero_stage``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "spec_for", "param_specs",
           "WARN_FALLBACK_ELEMENTS", "FUSED_OPS_UNDER_MODEL"]

FUSED_OPS_UNDER_MODEL = (
    "fused_ops on the ViT with tpu.mesh.model > 1: kernel 8 fuses the MLP "
    "that 'model' splits (a split kernel 8 is ROADMAP queue 2's kernel "
    "work; fused_ops is the port's own option)")

# A spec names, for each dim of a leaf in the JAX layout, the mesh axis it
# is split over, or None; () replicates the leaf.
Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis name -> size in grid order, as ``jax.sharding.Mesh.
    shape`` reads; ``rank``: this process's coordinate on 'data';
    ``device_mesh``: the ``DeviceMesh`` over the ranks (None in a process
    that joined no group, where the mesh is one device); ``coords``: the
    coordinate on every axis (None: 0 on every axis but 'data');
    ``expert_model``: the group of the ranks that share this rank's
    'data', 'seq' and 'stage' coordinates (the 'expert' x 'model' block;
    None in one process); ``data_seq``: the group of the ranks that share
    its 'expert', 'model' and 'stage' coordinates (the 'data' x 'seq'
    block, made where 'seq' exceeds 1). The steps reduce over the ranks of
    a mesh over a joined group whatever its size, a group of one rank
    included."""

    shape: Dict[str, int]
    rank: int = 0
    device_mesh: Optional[object] = None
    coords: Optional[Dict[str, int]] = None
    expert_model: Optional[object] = None
    data_seq: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def size(self, axis: str) -> int:
        """The size of ``axis``, 1 for an axis the mesh does not hold."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis of one)."""
        if axis == "data":
            return self.rank
        return (self.coords or {}).get(axis, 0)

    @property
    def splits_state(self) -> bool:
        """Whether 'model', 'expert' or 'stage' splits the parameters."""
        return any(self.size(a) > 1 for a in ("model", "expert", "stage"))

    def group(self, axis: str = "data"):
        """The process group of ``axis`` (None in one process)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def data_seq_group(self):
        """The group over which a quantity of the whole batch and sequence
        is summed: the 'data' x 'seq' block, or 'data' where 'seq' is 1."""
        return self.data_seq if self.data_seq is not None \
            else self.group("data")


def make_mesh(data: int = -1, model: int = 1, stage: int = 1,
              expert: int = 1, seq: int = 1, device_type: str = "cuda"
              ) -> Mesh:
    """A ('data'[, 'seq'][, 'expert'], 'model'[, 'stage']) mesh over the
    processes of the group (one process when none was joined); 'seq',
    'expert' and 'stage' are only materialized when > 1, as in JAX.
    ``data=-1`` takes the world size over the other axes; a mesh of more
    ranks than there are raises the JAX package's oversubscription
    message, and one of fewer raises too (every rank has a place on the
    mesh). 'seq' with 'stage' raises the JAX model's words."""
    model, stage, expert, seq = (max(a, 1) for a in (model, stage, expert,
                                                      seq))
    if seq > 1 and stage > 1:
        raise NotImplementedError(
            "tpu.mesh.seq > 1 does not compose with tpu.mesh.stage "
            "> 1: the GPipe executor's shard_map cannot nest the "
            "ring-attention shard_map")
    joined = dist.is_initialized()
    world_size = dist.get_world_size() if joined else 1
    if data == -1:
        data = world_size // (model * stage * expert * seq)
    n = data * model * stage * expert * seq
    if data < 1 or n > world_size:
        raise ValueError(
            f"mesh {max(data, 0)}x{seq}x{expert}x{model}x{stage} "
            f"(data x seq x expert x model x stage) needs "
            f"{max(n, seq * expert * model * stage)} devices, "
            f"have {world_size}")
    if n < world_size:
        raise ValueError(
            f"mesh of {n} devices in a group of {world_size} processes: "
            "every process is one 'data' shard of the 'seq' x 'expert' x "
            "'model' x 'stage' block (tpu.mesh.data=-1 takes them all)")
    shape = {"data": data}
    if seq > 1:
        shape["seq"] = seq
    if expert > 1:
        shape["expert"] = expert
    shape["model"] = model
    if stage > 1:
        shape["stage"] = stage
    if not joined:
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device_type, tuple(shape.values()),
                                   mesh_dim_names=tuple(shape))
    me = dist.get_rank()
    grid = np.arange(world_size).reshape(tuple(shape.values()))
    coords = {axis: int(c) for axis, c in zip(
        shape, np.unravel_index(me, grid.shape))}
    names = list(shape)

    def blocks(axes):
        """new_group for every block of ``axes`` (a collective: every rank
        makes every block's group); returns the one holding this rank."""
        inner = [names.index(a) for a in axes if a in shape]
        outer = [i for i in range(len(names)) if i not in inner]
        ranks = np.transpose(grid, outer + inner).reshape(
            -1, int(np.prod([grid.shape[i] for i in inner], dtype=int)))
        mine = None
        for row in ranks:
            group = dist.new_group([int(r) for r in row])
            if me in row:
                mine = group
        return mine

    expert_model = blocks(("expert", "model"))
    data_seq = blocks(("data", "seq")) if seq > 1 else None
    return Mesh(shape, coords["data"], device_mesh, coords, expert_model,
                data_seq)


# ------------------------------------------------------- placement rules
# The JAX package's rules (dl_vqa_tpu/parallel/mesh.py::_spec_for), by the
# path of a leaf in the JAX parameter tree, as data: (how the path
# matches, the pattern, the spec). The first match wins; a conv weight
# ([1, 1, in, out]) and a linear one ([in, out]) both split their last
# dim, so the 'last' spec fills the leading dims with None.
_RULES = (
    ("in", "classifier/lin1/w", (None, "model")),
    ("in", "classifier/lin1/b", ("model",)),
    ("in", "classifier/lin2/w", ("model", None)),
    ("in", "text/embedding", ("model", None)),
    ("in", "attention/q_lin/w", "last"),
    ("in", "attention/v_conv/w", "last"),
    ("in", "attention/q_lin/b", ("model",)),
    # The MoE rules precede the generic ones: '/moe/out/w' would otherwise
    # take the row-parallel '/out/w' rule and lose its 'expert' split.
    ("end", "/moe/in/w", ("expert", None, "model")),
    ("end", "/moe/in/b", ("expert", "model")),
    ("end", "/moe/out/w", ("expert", "model", None)),
    ("end", "/moe/out/b", ("expert", None)),
    ("end", "/qkv/w", (None, "model")),
    ("end", "/mlp_in/w", (None, "model")),
    ("end", "/qkv/b", ("model",)),
    ("end", "/mlp_in/b", ("model",)),
    ("end", "/out/w", ("model", None)),
    ("end", "/mlp_out/w", ("model", None)),
)

# Leaves at least this large that fall back to replication are warned of,
# as the JAX package warns of them.
WARN_FALLBACK_ELEMENTS = 65_536

_log = logging.getLogger(__name__)


def spec_for(path: str, ndim: int) -> Spec:
    """The tensor-parallel spec of the leaf at ``path`` (``/``-joined keys
    of the JAX tree, a leading ``/``) of ``ndim`` dims, before the stacked
    ViT layer axis and the mesh are considered: the JAX package's
    ``_spec_for``."""
    for how, pattern, spec in _RULES:
        if (pattern in path) if how == "in" else path.endswith(pattern):
            if spec == "last":
                return (None,) * (ndim - 1) + ("model",)
            return spec
    return ()


def _divisible(shape: Sequence[int], spec: Spec,
               sizes: Dict[str, int]) -> bool:
    return all(axis is None or shape[dim] % sizes[axis] == 0
               for dim, axis in enumerate(spec))


def _head_split(path: str) -> bool:
    """Whether ``path`` is a leaf of a transformer block's attention that
    the port splits by heads: ``qkv`` (column-parallel) and ``out``
    (row-parallel), of the ViT's or the text encoder's blocks."""
    return (("/image/layers/" in path or "/text/layers/" in path)
            and path.endswith(("/qkv/w", "/qkv/b", "/out/w"))
            and "/moe/" not in path)


def param_specs(tree, sizes: Dict[str, int], log=None,
                heads: Optional[Dict[str, int]] = None):
    """The spec of every leaf of the JAX parameter ``tree`` (numpy arrays
    or anything with a ``shape``) on a mesh of axis ``sizes``, as a tree of
    the same structure: the JAX package's ``param_shardings``. The stacked
    ViT layer axis (``/image/layers/``) takes 'stage' where the mesh
    pipelines; an axis the mesh does not hold, or of size 1, replicates
    its dim; a leaf whose split dims do not divide their axes replicates
    whole, and one of at least :data:`WARN_FALLBACK_ELEMENTS` elements is
    named in a warning (the JAX words; through ``log`` if given, else the
    ``logging`` module). ``heads``: the head counts of the ``image`` and
    ``text`` transformer blocks; a block whose count the 'model' axis does
    not divide keeps its ``qkv`` and ``out`` whole, as a leaf that does not
    divide (the port splits them by heads)."""
    fallbacks = []
    heads = heads or {}
    model = sizes.get("model", 1)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        shape = tuple(node.shape)
        stacked = "/image/layers/" in prefix
        spec = spec_for(prefix, len(shape) - stacked)
        if stacked:
            spec = ("stage",) + spec
        spec = tuple(axis if axis is not None and sizes.get(axis, 1) > 1
                     else None for axis in spec)
        part = prefix.split("/")[1] if prefix.count("/") > 1 else ""
        whole_heads = (_head_split(prefix) and "model" in spec
                       and heads.get(part, model) % model != 0)
        if whole_heads or not _divisible(shape, spec, sizes):
            if int(np.prod(shape)) >= WARN_FALLBACK_ELEMENTS:
                fallbacks.append((prefix, shape, spec))
            spec = (("stage",) + (None,) * (len(shape) - 1)
                    if stacked and sizes.get("stage", 1) > 1
                    and shape[0] % sizes["stage"] == 0 else ())
        if all(axis is None for axis in spec):
            spec = ()
        return spec

    specs = walk(tree, "")
    if fallbacks:
        details = "; ".join(f"{path} shape={shape} wanted "
                            f"PartitionSpec{spec!r}"
                            for path, shape, spec in fallbacks)
        message = (
            f"tensor-parallel fallback to replication on mesh "
            f"{dict(sizes)} for: {details} — make the sharded dim a "
            "multiple of the 'model' axis (round max_answers / vocab up) or "
            "reduce tpu.mesh.model")
        (log or _log.warning)(message)
    return specs
