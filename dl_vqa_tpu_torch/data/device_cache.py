"""Device-resident image table (``tpu.device_image_cache``).

The port's copy of ``dl_vqa_tpu/data/device_cache.py``: the whole fp16
feature store is uploaded once as an NHWC table on the card, batches then
carry only ``image_rows``, and the step gathers the batch's images on the
device (``index_select``, the JAX step's ``table[rows]``). ``auto``
uploads when the distinct stores fit the budget
(``tpu.device_image_cache_budget_gb``, 4 GiB when 0), ``on`` always, and
``off`` never (the batch then carries its images through pinned memory).
Datasets that share one ``image_path`` share one table.

Two layouts (``tpu.device_image_cache_layout``), as there:

* ``replicated`` (default): every rank holds the whole table; the step's
  gather is a local ``index_select``;
* ``sharded``: over a mesh with more than one 'data' shard, rank ``r``
  holds row block ``r`` of ``ceil(N / data)`` rows (read alone from the
  store), so the capacity grows with the mesh: the budget charges a rank's
  bytes, and ``auto`` admits a store of up to ``data`` times the budget.
  A batch's images come as the JAX package lowers ``table[rows]`` on a
  row-sharded table (:meth:`ShardedImageTable.index_select`, which the
  steps call as they call a whole table's): the ranks all-gather the
  global batch's rows, each gathers the rows it owns with ``-0.0``
  elsewhere, and a reduce-scatter over 'data' sums each rank's rows to
  it. One rank contributes each row and ``x + -0.0 == x`` for every fp16
  ``x``, so the images, and the losses, are the replicated layout's bits.
  With one 'data' shard it is the replicated layout.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["cache_mode", "plan_image_tables", "BUDGET_BYTES",
           "ShardedImageTable"]

BUDGET_BYTES = 4 << 30


def cache_mode(cfg: dict) -> str:
    """``tpu.device_image_cache`` as 'auto' | 'on' | 'off' (a bare on/off
    override reads as a boolean)."""
    raw = cfg["tpu"].get("device_image_cache", "auto")
    if raw is True:
        return "on"
    if raw is False:
        return "off"
    if raw not in ("auto", "on", "off"):
        raise ValueError(
            f"tpu.device_image_cache must be 'auto', 'on', or 'off'; "
            f"got {raw!r}")
    return raw


def _budget_bytes(cfg: dict) -> int:
    gb = cfg["tpu"].get("device_image_cache_budget_gb", 0)
    if gb < 0:
        raise ValueError(
            f"tpu.device_image_cache_budget_gb must be >= 0 (0 means the "
            f"default {BUDGET_BYTES >> 30} GiB); got {gb!r}")
    return int(gb * 2**30) if gb else BUDGET_BYTES


class ShardedImageTable:
    """This rank's row block ``[start, start + len(local))`` of an image
    table of ``rows`` rows split over the mesh's 'data' axis (the
    ``sharded`` layout); :meth:`index_select` gives a batch its images,
    as ``Tensor.index_select`` does from a whole table."""

    def __init__(self, local: torch.Tensor, start: int, rows: int, mesh):
        self.local, self.start, self.rows = local, int(start), int(rows)
        self.group, self.world = mesh.group("data"), mesh.shape["data"]

    def to(self, device) -> "ShardedImageTable":
        self.local = self.local.to(device)
        return self

    def index_select(self, dim: int, rows: torch.Tensor) -> torch.Tensor:
        """The images of this rank's ``rows`` of the global batch (every
        rank calls this with its rows, of one size; ``dim`` is 0): the JAX
        lowering of ``table[rows]`` on a row-sharded table, as an
        all-gather of the row ids and a reduce-scatter of the images."""
        import torch.distributed as dist

        if dim != 0:
            raise ValueError(f"a sharded image table selects rows (dim 0), "
                             f"not dim {dim}")

        everyone = [torch.empty_like(rows) for _ in range(self.world)]
        dist.all_gather(everyone, rows.contiguous(), group=self.group)
        wanted = torch.cat(everyone).long() - self.start
        held = self.local.shape[0]
        owned = (wanted >= 0) & (wanted < held)
        shape = (wanted.shape[0],) + tuple(self.local.shape[1:])
        minus_zero = self.local.new_full((), -0.0)
        if held:
            picked = self.local.index_select(0, wanted.clamp(0, held - 1))
            picked = torch.where(owned.view(-1, *[1] * (len(shape) - 1)),
                                 picked, minus_zero)
        else:
            picked = minus_zero.expand(shape).contiguous()
        out = self.local.new_empty((rows.shape[0],) + shape[1:])
        dist.reduce_scatter(out, list(picked.chunk(self.world)),
                            group=self.group)
        return out


def _layout(cfg: dict, mesh) -> str:
    raw = cfg["tpu"].get("device_image_cache_layout", "replicated")
    if raw not in ("replicated", "sharded"):
        raise ValueError(
            f"tpu.device_image_cache_layout must be 'replicated' or "
            f"'sharded'; got {raw!r}")
    if raw == "sharded" and (mesh is None or mesh.shape["data"] < 2):
        return "replicated"  # nothing to shard over
    return raw


def plan_image_tables(cfg: dict, datasets: Dict[str, object], device,
                      log=None, mesh=None) -> Dict[str, Optional[object]]:
    """Decide and make the uploads: ``{name: fp16 [N, H, W, 3] table on
    device, a :class:`ShardedImageTable` of this rank's rows in the
    ``sharded`` layout over ``mesh``, or None}`` matching ``datasets``."""
    mode = cache_mode(cfg)
    out: Dict[str, Optional[object]] = {k: None for k in datasets}
    if mode == "off":
        return out
    layout = _layout(cfg, mesh)
    shards = mesh.shape["data"] if layout == "sharded" else 1
    distinct_nbytes: Dict[str, int] = {}
    for ds in datasets.values():
        if getattr(ds, "has_image_rows", False):
            distinct_nbytes[ds.image_path] = ds.image_store_nbytes
    total = sum(distinct_nbytes.values())
    if total == 0:
        return out
    budget = _budget_bytes(cfg)
    # A rank of the sharded layout holds ceil(rows / data) rows at most.
    per_rank = -(-total // shards)
    if mode == "auto" and per_rank > budget:
        if log:
            log(f"Image store ({per_rank / 2**20:.0f} MiB/device, "
                f"layout={layout}) exceeds the device-cache budget "
                f"({budget / 2**20:.0f} MiB); using per-batch host transfer "
                "(tpu.device_image_cache=on to force, or "
                "device_image_cache_layout=sharded to split over the data "
                "mesh)")
        return out
    if log:
        log(f"Device-resident image cache: uploading "
            f"{total / 2**20:.0f} MiB of image features"
            + (f" row-sharded over {shards} 'data' devices"
               if shards > 1 else ""))
    uploaded: Dict[str, object] = {}
    for name, ds in datasets.items():
        if not getattr(ds, "has_image_rows", False):
            continue
        if ds.image_path not in uploaded:
            uploaded[ds.image_path] = _upload(ds, device, mesh, shards)
        out[name] = uploaded[ds.image_path]
    return out


def _upload(ds, device, mesh, shards: int):
    """One store on ``device``: whole, or this rank's row block of it."""
    if shards == 1:
        return torch.from_numpy(ds.features_nhwc_all()).to(device)
    from dl_vqa_tpu_torch.parallel.multihost import process_dim0_block

    rows = ds.image_store_rows
    block = process_dim0_block(mesh, (rows,))
    local = torch.from_numpy(ds.features_nhwc_all(rows=block)).to(device)
    return ShardedImageTable(local, block.start, rows, mesh)
