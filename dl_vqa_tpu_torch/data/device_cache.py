"""Device-resident image table (``tpu.device_image_cache``).

The port's copy of ``dl_vqa_tpu/data/device_cache.py``: the whole fp16
feature store is uploaded once as an NHWC table on the card, batches then
carry only ``image_rows``, and the step gathers the batch's images on the
device (``index_select``, the JAX step's ``table[rows]``). ``auto``
uploads when the distinct stores fit the budget
(``tpu.device_image_cache_budget_gb``, 4 GiB when 0), ``on`` always, and
``off`` never (the batch then carries its images through pinned memory).
Datasets that share one ``image_path`` share one table.

Only the ``replicated`` layout exists on one card; ``sharded`` (rows split
over a data mesh) raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["cache_mode", "plan_image_tables", "BUDGET_BYTES"]

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


def _check_layout(cfg: dict) -> None:
    raw = cfg["tpu"].get("device_image_cache_layout", "replicated")
    if raw == "sharded":
        raise NotImplementedError(
            "tpu.device_image_cache_layout=sharded splits the table over a "
            "data mesh, which dl_vqa_tpu_torch does not have yet (ROADMAP "
            "queue 1, item 9, the parallel axes); use 'replicated'")
    if raw != "replicated":
        raise ValueError(
            f"tpu.device_image_cache_layout must be 'replicated' or "
            f"'sharded'; got {raw!r}")


def plan_image_tables(cfg: dict, datasets: Dict[str, object], device,
                      log=None) -> Dict[str, Optional[torch.Tensor]]:
    """Decide and make the uploads: ``{name: fp16 [N, H, W, 3] table on
    device, or None}`` matching ``datasets``."""
    mode = cache_mode(cfg)
    out: Dict[str, Optional[torch.Tensor]] = {k: None for k in datasets}
    if mode == "off":
        return out
    _check_layout(cfg)
    distinct_nbytes: Dict[str, int] = {}
    for ds in datasets.values():
        if getattr(ds, "has_image_rows", False):
            distinct_nbytes[ds.image_path] = ds.image_store_nbytes
    total = sum(distinct_nbytes.values())
    if total == 0:
        return out
    budget = _budget_bytes(cfg)
    if mode == "auto" and total > budget:
        if log:
            log(f"Image store ({total / 2**20:.0f} MiB) exceeds the "
                f"device-cache budget ({budget / 2**20:.0f} MiB); using "
                "per-batch host transfer (tpu.device_image_cache=on to "
                "force)")
        return out
    if log:
        log(f"Device-resident image cache: uploading "
            f"{total / 2**20:.0f} MiB of image features")
    uploaded: Dict[str, torch.Tensor] = {}
    for name, ds in datasets.items():
        if not getattr(ds, "has_image_rows", False):
            continue
        if ds.image_path not in uploaded:
            host = torch.from_numpy(ds.features_nhwc_all())
            uploaded[ds.image_path] = host.to(device)
        out[name] = uploaded[ds.image_path]
    return out
