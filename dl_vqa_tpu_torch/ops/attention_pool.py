"""Glimpse softmax pooling: per glimpse, a softmax over the spatial grid and
the weighted sum of the image features, glimpses concatenated.

Port of :mod:`dl_vqa_tpu.ops.attention_pool`. Kernel 3
(``csrc/attention_pool.cu``) replaces
``dl_vqa_tpu/ops/attention_pool.py::_pool_kernel``.

Kernel 3, what bounds it on this card: reading ``v`` (512 x 676 x 256 f32
= 177 MB at batch 512). The plain version materialises the softmax
weights and reads ``v`` through a batched matmul; the TPU kernel re-read
``v`` once per glimpse. The design keeps one sample's ``att`` (676 x 2
values) in shared memory, turns it into softmax weights there, and
streams ``v`` once, accumulating every glimpse from the same load.

The gradient (:class:`AttentionPool`) is plain PyTorch in closed form,
recomputing the softmax, as the JAX package's backward goes through its
plain version (``_pool_bwd``); a hand kernel for it is still to write.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["attention_pool_reference", "attention_pool_cuda",
           "attention_pool_backward", "AttentionPool", "attention_pool"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GLIMPSES = 8               # csrc/attention_pool.cu kMaxGlimpses
# att[b] in shared memory; with the kernel's 12 KB of static shared memory
# it stays under the 48 KB a launch gets without opting in.
_MAX_SHARED_BYTES = 32 * 1024


def attention_pool_reference(v: torch.Tensor, att: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of kernel 3: ``v [B, H, W, C]``, ``att [B, H, W, G]``
    -> ``[B, G * C]`` f32."""
    batch, h, w, channels = v.shape
    glimpses = att.shape[-1]
    v_flat = v.reshape(batch, h * w, channels).float()
    weights = torch.softmax(att.reshape(batch, h * w, glimpses).float(), dim=1)
    pooled = torch.einsum("bsg,bsc->bgc", weights, v_flat)
    return pooled.reshape(batch, glimpses * channels)


def attention_pool_cuda(v: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """Kernel 3 on ``v``'s CUDA device; raises on any input it does not
    take."""
    if v.dim() != 4 or att.dim() != 4 or v.shape[:3] != att.shape[:3]:
        raise ValueError(f"expected v [B,H,W,C] and att [B,H,W,G]; got "
                         f"{tuple(v.shape)}, {tuple(att.shape)}")
    if not v.is_cuda or att.device != v.device:
        raise ValueError(f"v and att must be CUDA tensors on one device; "
                         f"got {v.device}, {att.device}")
    if v.dtype not in _DTYPES or att.dtype != v.dtype:
        raise ValueError(f"v and att must share a dtype in {list(_DTYPES)}; "
                         f"got {v.dtype}, {att.dtype}")
    if not (v.is_contiguous() and att.is_contiguous()):
        raise ValueError("v and att must be contiguous (NHWC)")
    batch, h, w, channels = v.shape
    glimpses = att.shape[-1]
    spatial = h * w
    if not 1 <= glimpses <= _MAX_GLIMPSES:
        raise ValueError(f"glimpses must be in 1..{_MAX_GLIMPSES}, "
                         f"got {glimpses}")
    if spatial * glimpses * 4 > _MAX_SHARED_BYTES:
        raise ValueError(f"att of {spatial} x {glimpses} does not fit the "
                         "kernel's shared memory")
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the launch grid (65535)")
    lib = _native.library()
    out = torch.empty(batch, glimpses * channels, dtype=torch.float32,
                      device=v.device)
    code = lib.vqa_attention_pool(
        v.data_ptr(), att.data_ptr(), out.data_ptr(), batch, spatial,
        channels, glimpses, _DTYPES[v.dtype], _native.stream_ptr(v.device))
    _native.check("attention_pool", code)
    if batch and channels:  # the C entry launches nothing for empty input
        attention_pool_cuda.launches += 1
    return out


attention_pool_cuda.launches = 0


def attention_pool_backward(g: torch.Tensor, v: torch.Tensor,
                            att: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dv, datt)`` for the cotangent ``g [B, G * C]`` of the pooled
    output, in f32 and then in the inputs' dtypes. With ``w =
    softmax(att)`` over the grid: ``dv[b,s,c] = sum_g w[b,s,g] g[b,g,c]``,
    ``p[b,s,g] = sum_c v[b,s,c] g[b,g,c]``, ``datt = w (p - sum_s w p)``."""
    batch, h, w, channels = v.shape
    glimpses = att.shape[-1]
    g = g.reshape(batch, glimpses, channels).float()
    v_flat = v.reshape(batch, h * w, channels).float()
    weights = torch.softmax(att.reshape(batch, h * w, glimpses).float(), dim=1)
    dv = torch.einsum("bsg,bgc->bsc", weights, g)
    p = torch.einsum("bsc,bgc->bsg", v_flat, g)
    datt = weights * (p - (weights * p).sum(dim=1, keepdim=True))
    return dv.reshape(v.shape).to(v.dtype), datt.reshape(att.shape).to(att.dtype)


class AttentionPool(torch.autograd.Function):
    """``(v, att, plain) -> pooled``: kernel 3 forward (its plain version
    for a CPU tensor or ``plain=True``), :func:`attention_pool_backward`
    backward."""

    @staticmethod
    def forward(ctx, v, att, plain):
        ctx.save_for_backward(v, att)
        if plain or v.device.type == "cpu":
            return attention_pool_reference(v, att)
        return attention_pool_cuda(v, att)

    @staticmethod
    def backward(ctx, g):
        dv, datt = attention_pool_backward(g, *ctx.saved_tensors)
        return dv, datt, None


def attention_pool(v: torch.Tensor, att: torch.Tensor,
                   plain: bool = False) -> torch.Tensor:
    """Differentiable glimpse pooling. Dispatch: a CPU tensor, or
    ``plain=True``, runs :func:`attention_pool_reference`; any other
    device runs kernel 3, which raises where it cannot launch."""
    return AttentionPool.apply(v, att, plain)
