"""int8 W8A8 for the ViT block products (serving mode): port of
``dl_vqa_tpu/ops/vit_int8.py``.

Weights are quantized per output channel from the parameters
(``conv_int8.quantize_weights_per_channel``, which takes a linear's
``[out, in]`` as it takes a conv's weight);
activations with static per-site scales from a calibration pass, four
sites a block, in order: the qkv input (after LN1), the out projection's
input (the attention core's output), the MLP's input (after LN2) and the
second MLP product's input (the ReLU hidden, kept in f32).
``ImageConfig.quant_scales`` holds the ``4 * num_layers`` amaxes. The
attention core (kernel 4) and the patch embedding stay in the compute
dtype. Serving only: ``ModelConfig.check_ported`` refuses it in training.

The integer product is ``torch._int_mm`` (s8 x s8 -> s32), as the JAX
package leaves it to XLA's ``dot_general`` outside any Pallas kernel; it
takes more than 16 rows and a depth and width that are multiples of 8
(the ViT's 196 tokens a image and its 256 / 768 / 1024 widths), and a
shape that is not raises here. It is exact, so the port differs from the
JAX package only where the f32 epilogue rounds otherwise.

Under 'model' (``VitBlock``'s split products) a column-parallel site
(``qkv``, ``mlp_in``) holds whole output channels and quantizes them as
one process does. A row-parallel site (``out``, ``mlp_out``) holds a slice
of every channel's inputs: each channel's weight amax is the maximum over
the 'model' ranks, and the ranks' s32 partial products are summed (exact)
before the one f32 epilogue and the bias, so the ranks give one process's
codes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from dl_vqa_tpu_torch.ops.conv_int8 import (
    f32, fma_f32, quantize_weights_per_channel)

__all__ = ["w8a8_linear", "calibrate_vit_scales",
           "with_calibrated_vit_scales"]


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [m, k] @ b [k, n]`` in s8 x s8 -> s32; raises for a shape that
    ``torch._int_mm`` does not take on the card."""
    m, k = a.shape
    n = b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"the int8 product takes more than 16 rows and a depth and "
            f"width that are multiples of 8; got [{m}, {k}] @ [{k}, {n}]")
    return torch._int_mm(a, b)


def w8a8_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                s_in: float, dtype: torch.dtype, row=None) -> torch.Tensor:
    """``x @ w^T + b`` on the integer product: ``x [..., in]`` quantized
    with the static amax ``s_in`` (values beyond it saturate at +-127),
    ``w [out, in]`` quantized per channel; the s32 result times ``w_scale *
    (s_in / 127)`` plus the f32 bias, rounded once as XLA's contracted
    multiply-add rounds it (:func:`~dl_vqa_tpu_torch.ops.conv_int8.
    fma_f32`), in ``dtype``. ``row``: the 'model' Shard of a row-parallel
    site, whose ``x`` and ``w`` hold this rank's slice of the inputs
    (module docstring)."""
    x_q = torch.clamp(torch.round(x.float() * f32(127.0 / s_in)), -127,
                      127).to(torch.int8)
    amax = None
    if row is not None:
        amax = w.detach().float().abs().amax(dim=1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=row.group)
    w_q, w_scale = quantize_weights_per_channel(w, amax)
    acc = _int_mm(x_q.reshape(-1, x_q.shape[-1]), w_q.t().contiguous())
    if row is not None:
        dist.all_reduce(acc, group=row.group)
    y = fma_f32(acc.float(), w_scale * f32(s_in / 127.0), b.detach().float())
    return y.reshape(*x.shape[:-1], -1).to(dtype)


@torch.no_grad()
def calibrate_vit_scales(model, images, dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[float, ...]:
    """Per-site amaxes of :class:`~dl_vqa_tpu_torch.models.vqa.VqaNet`
    ``model``'s ViT over ``images`` (``[B, H, W, 3]``, uint8 pixels or
    normalised floats) from its exact forward in ``dtype`` (the kernels on
    the card, the unfused blocks), collected by an amax sink in block
    order: ``4 * num_layers`` Python floats."""
    from dl_vqa_tpu_torch.models.layers import normalize_images

    device = next(model.parameters()).device
    sink = []
    model.image(normalize_images(torch.as_tensor(images).to(device), dtype),
                dtype, False, None, amax_sink=sink)
    vals = torch.stack(sink).cpu().numpy()
    if not np.all(np.isfinite(vals)) or np.any(vals <= 0):
        raise ValueError(
            f"vit int8 calibration produced non-positive/non-finite "
            f"amaxes {vals}; check the calibration batch and params")
    expected = 4 * model.cfg.image.num_layers
    if len(vals) != expected:
        raise AssertionError(
            f"calibration collected {len(vals)} amaxes, expected "
            f"{expected} (4 per block)")
    return tuple(float(v) for v in vals)


def with_calibrated_vit_scales(cfg, model, images,
                               dtype: torch.dtype = torch.bfloat16):
    """:func:`calibrate_vit_scales` on ``images``, returned as ``cfg`` with
    ``image.store_dtype='int8'`` and ``image.quant_scales`` set."""
    scales = calibrate_vit_scales(model, images, dtype=dtype)
    return dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, store_dtype="int8", quant_scales=scales))
