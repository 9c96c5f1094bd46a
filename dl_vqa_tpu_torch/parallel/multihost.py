"""The multi-process tier: one process per GPU, joined by
``torch.distributed``.

The port's counterpart of ``dl_vqa_tpu/parallel/multihost.py``. The JAX
package runs one process per host, each driving its local chips, and
builds one global mesh over them; the port runs one process per GPU (the
torchrun idiom), so a process is one place on the mesh, and its 'data'
coordinate says which rows of a batch it feeds (the ranks of one 'expert'
x 'model' group feed the same rows). The contract is the JAX one:

* every process runs the same program (``torchrun --nproc-per-node=N -m
  dl_vqa_tpu_torch.main ...``, multi-node with ``--nnodes``), and
  :func:`maybe_initialize` joins the group from torchrun's environment;
* every process feeds only its 'data' shard's rows of every global
  batch (:func:`process_batch_slice`, ``Batcher(process_slice=...)``):
  its contiguous block, or under gradient accumulation its block of each
  micro-batch; the shuffle order is shared through the seed, so the
  processes agree on each global batch;
* the train and eval steps reduce what crosses processes (gradients, the
  loss's real count, the metrics), so every process reports the same
  global numbers, and only the coordinator (rank 0) writes logs and
  checkpoints.

The backend is NCCL for CUDA devices and gloo for the CPU unless the
caller names one; nothing switches backend or device because one fails.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np

import torch
import torch.distributed as dist

__all__ = [
    "maybe_initialize",
    "initialize",
    "active",
    "is_coordinator",
    "barrier",
    "process_batch_slice",
    "process_dim0_block",
    "backend_for",
    "rank_device",
    "TORCHRUN_ENV",
]

# What torchrun (and torch.distributed.run) exports to every process.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` for a CUDA device in
    a torchrun launch, else ``device`` as the caller passed it."""
    device = torch.device(device)
    local = os.environ.get("LOCAL_RANK")
    if device.type == "cuda" and local is not None and device.index is None:
        return torch.device("cuda", int(local))
    return device


def initialize(backend: str) -> None:
    """``torch.distributed.init_process_group`` from torchrun's
    environment (a no-op once joined)."""
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")


def maybe_initialize(log=None, device="cuda",
                     backend: Optional[str] = None) -> bool:
    """Join the process group iff torchrun's environment is set; return
    whether this run has more than one process.

    With none of :data:`TORCHRUN_ENV` set this is a no-op (a group the
    caller joined itself is reported as it is). With part of it set it
    raises, naming what is missing. ``backend`` defaults to
    :func:`backend_for` ``device``; a CUDA process first selects its card,
    ``cuda:LOCAL_RANK``."""
    present = [name for name in TORCHRUN_ENV if os.environ.get(name)]
    if not present:
        return active()
    missing = [name for name in TORCHRUN_ENV if not os.environ.get(name)]
    if missing:
        raise ValueError(
            f"incomplete torchrun environment: {', '.join(present)} set but "
            f"{', '.join(missing)} missing (launch with torchrun, or set "
            f"all of {', '.join(TORCHRUN_ENV)})")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize(backend or backend_for(device))
    if log is not None:
        log(f"multihost: rank {dist.get_rank()}/{dist.get_world_size()} "
            f"on {device} ({dist.get_backend()})")
    return active()


def active() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_coordinator() -> bool:
    """True on the process that writes logs and checkpoints (rank 0, or
    the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(name: str) -> None:
    """Rendezvous of every process (a no-op in one process): the
    coordinator builds the caches, the others wait here and load them.
    ``name`` labels the wait in a hang's traceback."""
    del name
    if active():
        dist.barrier()


def process_batch_slice(mesh, global_batch_size: int, accum_steps: int = 1
                        ) -> Union[None, slice, np.ndarray]:
    """This process's rows of a ``[global_batch_size, ...]`` batch split
    over the mesh's 'data' axis, by its 'data' coordinate; ``None`` where
    'data' has one shard (feed whole batches). With ``accum_steps == 1``
    they are one contiguous block (a slice). With more, a train step
    splits the global batch into ``accum_steps`` contiguous micro-batches,
    as the JAX step does, and the process takes its contiguous block of
    each (an index array): its k-th chunk is its share of global
    micro-batch k."""
    n = mesh.shape["data"]
    if n == 1:
        return None
    if global_batch_size % (n * accum_steps):
        raise ValueError(
            f"train.batch_size={global_batch_size} does not split over the "
            f"'data' axis of {n} processes"
            + (f" into {accum_steps} micro-batches" if accum_steps > 1
               else ""))
    if accum_steps == 1:
        return process_dim0_block(mesh, (global_batch_size,))
    micro = global_batch_size // accum_steps
    block = process_dim0_block(mesh, (micro,))
    return (np.arange(accum_steps)[:, None] * micro
            + np.arange(block.start, block.stop)[None, :]).reshape(-1)


def process_dim0_block(mesh, global_shape: Sequence[int]) -> slice:
    """The contiguous dim-0 rows of an array of ``global_shape`` that this
    process holds when dim 0 is split over 'data': block ``mesh.rank``
    (the 'data' coordinate) of ``data`` blocks of ``ceil(rows / data)``
    rows, clipped to the array (as JAX's 'data' sharding pads a row count
    that does not divide, the last blocks are short or empty)."""
    rows = int(global_shape[0])
    n = mesh.shape["data"]
    per = -(-rows // n)
    return slice(min(mesh.rank * per, rows), min((mesh.rank + 1) * per, rows))
