"""Layer norm + ReLU MLP + residual of a ViT block as one op, forward only.

Port of ``experiments/probe_vit_mlp_fused.py::fused_ln_mlp`` and its
``reference``. Kernel 8 (``csrc/vit_mlp_fused.cu``) replaces ``::_kernel``.
Per token row, with the weights in the port's ``[out, in]`` layout:
``ln = cast(layer_norm(x))`` (statistics in f32, eps 1e-5); ``h =
cast(relu(f32(ln W1^T) + b1))``; ``out = cast(f32(x) + f32(h W2^T) + b2)``:
products of operands rounded to ``x``'s dtype with f32 sums, and the
residual joins the f32 sum before the one cast.

That last step is where the op and the model's block part: ``VitBlock``
(as ``dl_vqa_tpu/models/vit.py``) rounds the MLP output to the compute
dtype before the residual add, the kernel (as the TPU kernel) after. In
f32 the two agree; in bf16 they differ by that rounding, once a block.

What bounds the kernel on this card is operations: 105 GFLOP a layer at
batch 512 (0.11 ms at the bf16 tensor cores' rate) against 0.1 GB moved.
The unfused block moves ``ln``, the ``[B, S, 4 D]`` hidden tensor and the
MLP output through device memory, with f32 copies around each product;
here ``x`` is read and ``out`` is written. The source note says how. In
bf16 the kernel reads its weights by wgmma descriptors, packed in that
layout by a first grid of the same call (:func:`pack_weights` is its plain
version), and :func:`row_plan` chooses the rows a block takes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from dl_vqa_tpu_torch.ops import _native
from dl_vqa_tpu_torch.ops.wgmma_layout import (
    ATOM, swizzle_index, swizzle_k_major)

__all__ = ["fused_ln_mlp_reference", "fused_ln_mlp_cuda", "fused_ln_mlp",
           "pack_weights", "row_plan", "KERNEL_DIMS",
           "HIDDEN_MULTIPLE", "WARPGROUP_ROWS", "GRIDS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DIMS = (64, 128, 256)  # model widths csrc/vit_mlp_fused.cu is built for
HIDDEN_MULTIPLE = 64          # its walk over the hidden units takes 64 a step
WARPGROUP_ROWS = 64           # rows a bf16 warpgroup takes (wgmma's M)
GRIDS = {torch.float32: 1, torch.bfloat16: 2}  # grids a call launches
_EPS = 1e-5


def fused_ln_mlp_reference(x: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8, in the kernel's order of operations.
    ``x [..., D]``, ``w1 [F, D]``, ``w2 [D, F]``; the products are f32
    products of operands rounded to ``x``'s dtype."""
    dtype = x.dtype
    x32 = x.float()
    centred = x32 - x32.mean(dim=-1, keepdim=True)
    var = (centred * centred).mean(dim=-1, keepdim=True)
    ln = (centred * torch.rsqrt(var + _EPS) * ln_scale.float()
          + ln_bias.float()).to(dtype)
    hidden = torch.relu(
        torch.matmul(ln.float(), w1.to(dtype).float().t()) + b1.float()
    ).to(dtype)
    mlp = torch.matmul(hidden.float(), w2.to(dtype).float().t()) + b2.float()
    return (x32 + mlp).to(dtype)


@functools.lru_cache(maxsize=None)
def _w2_index(dim: int, hidden: int, device: torch.device) -> torch.Tensor:
    """For each value of W2's packed chunks, its offset in ``[D, F]``."""
    tile = swizzle_index(dim, ATOM, device)  # offsets in a [D, 64] tile
    chunk = torch.arange(hidden // ATOM, device=device)[:, None]
    return (tile // ATOM * hidden + chunk * ATOM + tile % ATOM).reshape(-1)


def pack_weights(w1: torch.Tensor, w2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w1 [F, D]``, ``w2 [D, F]`` -> the bf16 kernel's operands: for each
    chunk of 64 hidden units, W1's rows ``[D / 64, 64, 64]`` and W2's
    columns ``[1, D, 64]``, K-major and swizzled (``ops/wgmma_layout.py``),
    so that a chunk of each is one run of memory. One gather each."""
    hidden, dim = w1.shape
    chunks = hidden // HIDDEN_MULTIPLE
    packed1 = swizzle_k_major(w1.reshape(chunks, HIDDEN_MULTIPLE, dim))
    packed2 = w2.reshape(-1)[_w2_index(dim, hidden, w2.device)]
    return packed1, packed2.reshape(chunks, 1, dim, ATOM)


def row_plan(rows: int, sm_count: int) -> Tuple[int, int, int]:
    """``(warpgroups, rows_per_block, blocks)`` of the bf16 kernel. Two
    64-row warpgroups a block where 128-row blocks still fill every SM, so
    that each weight byte fetched from L2 serves 128 rows; else one, so
    that small batches spread over twice the blocks. The plan changes only
    which rows share a block: every row sums over k in the same order."""
    warpgroups = 2 if rows >= 2 * WARPGROUP_ROWS * sm_count else 1
    per_block = warpgroups * WARPGROUP_ROWS
    return warpgroups, per_block, -(-rows // per_block)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_ln_mlp_cuda(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """Kernel 8 on ``x``'s CUDA device; raises on any input it does not
    take. The weights are rounded to ``x``'s dtype here, once a call; in
    bf16 the call packs them for wgmma into scratch it is given."""
    dim = x.shape[-1] if x.dim() else 0
    hidden = w1.shape[0] if w1.dim() == 2 else 0
    shapes = {"ln_scale": (ln_scale, (dim,)), "ln_bias": (ln_bias, (dim,)),
              "w1": (w1, (hidden, dim)), "b1": (b1, (hidden,)),
              "w2": (w2, (dim, hidden)), "b2": (b2, (dim,))}
    if x.dim() < 2 or any(tuple(t.shape) != want
                          for t, want in shapes.values()):
        raise ValueError(
            "expected x [..., D], ln_scale, ln_bias, b2 [D], w1 [F, D], "
            "b1 [F], w2 [D, F]; got x " + str(tuple(x.shape)) + ", "
            + ", ".join(f"{name} {tuple(t.shape)}"
                        for name, (t, _) in shapes.items()))
    if not x.is_cuda or any(t.device != x.device for t, _ in shapes.values()):
        raise ValueError("fused_ln_mlp_cuda takes CUDA tensors on one "
                         f"device; got x on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be one of {list(_DTYPES)}; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if dim not in KERNEL_DIMS or hidden < 1 or hidden % HIDDEN_MULTIPLE:
        raise ValueError(
            f"kernel 8 takes D in {KERNEL_DIMS} and F a multiple of "
            f"{HIDDEN_MULTIPLE}; got D={dim}, F={hidden}")
    rows = x.numel() // dim
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernel's int32 row count")
    lib = _native.library()
    held = [t.detach().float().contiguous()
            for t in (ln_scale, ln_bias, b1, b2)]
    weights = [t.detach().to(x.dtype).contiguous() for t in (w1, w2)]
    packed, warpgroups = None, 1
    if x.dtype == torch.bfloat16:
        packed = torch.empty(2, hidden * dim, dtype=x.dtype, device=x.device)
        warpgroups = row_plan(rows, _sm_count(x.device.index))[0]
    out = torch.empty_like(x)
    code = lib.vqa_vit_mlp_fused(
        x.data_ptr(), held[0].data_ptr(), held[1].data_ptr(),
        weights[0].data_ptr(), held[2].data_ptr(), weights[1].data_ptr(),
        held[3].data_ptr(), out.data_ptr(),
        None if packed is None else packed.data_ptr(), rows, dim, hidden,
        warpgroups, _DTYPES[x.dtype], _native.stream_ptr(x.device))
    _native.check("vit_mlp_fused", code)
    if rows:  # the C entry launches nothing for no row
        # bf16: two grids, the weights' packing, then the block.
        fused_ln_mlp_cuda.launches += GRIDS[x.dtype]
    return out


fused_ln_mlp_cuda.launches = 0


def fused_ln_mlp(x: torch.Tensor, ln_scale: torch.Tensor,
                 ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """``x + relu(ln(x) W1^T + b1) W2^T + b2``, forward only like the
    probe's kernel (an eval-path op without a gradient rule): it raises
    where a gradient would be recorded. Dispatch: a CPU tensor, or
    ``plain=True``, runs the plain version; any other device runs kernel
    8, which raises where it cannot launch."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ln_scale, ln_bias, w1, b1, w2, b2)):
        raise RuntimeError(
            "fused_ln_mlp is forward only: call it under torch.no_grad(), "
            "or use the block's unfused code for gradients")
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if plain or x.device.type == "cpu":
        return fused_ln_mlp_reference(*args)
    return fused_ln_mlp_cuda(*args)
