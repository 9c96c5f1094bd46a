"""The device mesh.

The port's counterpart of ``dl_vqa_tpu/parallel/mesh.py``. The JAX mesh
is a grid of chips with the axes ('data'[, 'seq'][, 'expert'], 'model'[,
'stage']); the port runs one process per GPU, so its mesh is a grid of
ranks with the same names, 'data' outermost (a
``torch.distributed.device_mesh.DeviceMesh`` once a process group is
joined). Only 'data' may exceed 1 here: tensor, expert, sequence and
pipeline parallelism are ROADMAP queue 1, item 9, and raise.

The JAX package's placements (``batch_sharding``, ``state_shardings``)
have no counterpart here: a rank holds its contiguous block of a batch's
rows (:func:`~dl_vqa_tpu_torch.parallel.multihost.process_batch_slice`),
and :mod:`dl_vqa_tpu_torch.parallel.zero` splits the train state by
wrapping the model (ZeRO, ``tpu.zero_stage``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]

_ITEM_9 = "ROADMAP queue 1, item 9, the parallel axes"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape``: axis name -> size in grid order, as ``jax.sharding.Mesh.
    shape`` reads; ``rank``: this process's coordinate on 'data';
    ``device_mesh``: the ``DeviceMesh`` over the ranks (None in a process
    that joined no group, where the mesh is one device). The steps reduce
    over the ranks of a mesh over a joined group whatever its size, a
    group of one rank included."""

    shape: Dict[str, int]
    rank: int = 0
    device_mesh: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.device_mesh is not None

    def group(self, axis: str = "data"):
        """The process group of ``axis`` (None in one process)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)


def make_mesh(data: int = -1, model: int = 1, stage: int = 1,
              expert: int = 1, seq: int = 1, device_type: str = "cuda"
              ) -> Mesh:
    """A ('data', 'model') mesh over the processes of the group (one
    process when none was joined). ``data=-1`` takes the world size over
    the other axes; a mesh of more ranks than there are raises the JAX
    package's oversubscription message, and one of fewer raises too (every
    rank is a 'data' shard). ``model``, ``stage``, ``expert`` and ``seq``
    above 1 raise ``NotImplementedError``."""
    model, stage, expert, seq = (max(a, 1) for a in (model, stage, expert,
                                                      seq))
    for name, size in zip(("model", "stage", "expert", "seq"),
                          (model, stage, expert, seq)):
        if size > 1:
            raise NotImplementedError(
                f"tpu.mesh.{name}={size}: dl_vqa_tpu_torch has only the "
                f"'data' axis ({_ITEM_9})")
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
            "every process is one 'data' shard (tpu.mesh.data=-1 takes "
            "them all)")
    shape = {"data": data, "model": model}
    device_mesh = None
    if joined:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device_type, tuple(shape.values()),
                                       mesh_dim_names=tuple(shape))
    return Mesh(shape, dist.get_rank() if joined else 0, device_mesh)
