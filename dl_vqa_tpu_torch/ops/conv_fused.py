"""Conv(k, k, VALID) -> bias -> ReLU -> 2x2 maxpool blocks, NHWC.

Port of :func:`dl_vqa_tpu.ops.conv_fused.conv_relu_pool` as the model runs
it (``conv_relu_pool_fastgrad``) and of
:func:`~dl_vqa_tpu.ops.conv_fused.conv_relu_pool_reference`. The conv is
``F.conv2d`` without bias in ``channels_last`` memory, output in the
input's dtype, and its gradients are autograd's, as the JAX package leaves
both to XLA. Bias, ReLU and the pool are kernel 2 (``csrc/relu_maxpool.cu``),
which replaces ``dl_vqa_tpu/ops/conv_fused.py::_relu_pool_kernel`` and
``::_relu_pool_direct_kernel``; their backward is kernel C
(``csrc/relu_maxpool_backward.cu``), the pool part of ``::_fastgrad_bwd``,
joined to kernel 2 in :class:`ReluMaxPool`.

Kernel 2, what bounds it on this card: nothing but memory traffic. It
reads the unpooled conv output once (512 x 222 x 222 x 64 bf16 = 3.2 GB
for conv0 at batch 512) and writes a quarter of it; the plain version
makes f32 copies of that tensor before it pools. The design reads each
input element once, one thread per output element with channels fastest
so that a warp's loads are contiguous, and applies bias, ReLU and the
cast after the max (they are monotone, so the bits are the same).

Kernel C, what bounds it: memory traffic again. It reads the raw conv
output and the pooled cotangent and writes ``dz`` of the conv output's
size (3.2 + 0.8 + 3.2 GB for conv0 at batch 512). The forward saves the
raw conv output, which the conv wrote anyway, and kernel C recomputes
``cast(relu(y + b))`` per element to decide ties as the JAX package does,
on the pooled values; saving those instead would cost one more 3.2 GB
write in the forward. The bias gradient is the pooled-side sum of the
gated cotangent, taken in the same pass.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from dl_vqa_tpu_torch.ops import _native

__all__ = ["conv_nhwc", "relu_maxpool_reference", "relu_maxpool_cuda",
           "relu_maxpool_backward_reference", "relu_maxpool_backward_cuda",
           "ReluMaxPool", "relu_maxpool", "conv_relu_pool_reference",
           "conv_relu_pool"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SHARED_BYTES = 32 * 1024  # kernel C keeps one f32 per channel there


def conv_nhwc(x: torch.Tensor, weight: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """VALID conv without bias: ``x [B, H, W, Cin]``, torch-layout
    ``weight [Cout, Cin, k, k]`` -> contiguous ``[B, Hc, Wc, Cout]`` in
    ``x``'s dtype."""
    w = weight.to(x.dtype).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def relu_maxpool_reference(y: torch.Tensor, bias: torch.Tensor
                           ) -> torch.Tensor:
    """Plain version of kernel 2: ``cast(relu(f32(y) + bias))`` then a
    2x2/2 floor max pool, ``[B, Hc, Wc, C]`` -> ``[B, Hc//2, Wc//2, C]``."""
    batch, hc, wc, channels = y.shape
    hp, wp = hc // 2, wc // 2
    z = torch.relu(y[:, :2 * hp, :2 * wp].float() + bias.float()).to(y.dtype)
    return z.reshape(batch, hp, 2, wp, 2, channels).amax(dim=(2, 4))


def relu_maxpool_cuda(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on ``y``'s CUDA device; raises on any input it does not
    take."""
    if y.dim() != 4 or bias.shape != (y.shape[-1],):
        raise ValueError(f"expected y [B,Hc,Wc,C] and bias [C]; got "
                         f"{tuple(y.shape)}, {tuple(bias.shape)}")
    if not y.is_cuda or bias.device != y.device:
        raise ValueError(f"y and bias must be CUDA tensors on one device; "
                         f"got {y.device}, {bias.device}")
    if y.dtype not in _DTYPES or bias.dtype != torch.float32:
        raise ValueError(f"y must be one of {list(_DTYPES)} and bias f32; "
                         f"got {y.dtype}, {bias.dtype}")
    if not (y.is_contiguous() and bias.is_contiguous()):
        raise ValueError("y and bias must be contiguous (NHWC)")
    batch, hc, wc, channels = y.shape
    lib = _native.library()
    out = torch.empty(batch, hc // 2, wc // 2, channels, dtype=y.dtype,
                      device=y.device)
    code = lib.vqa_relu_maxpool(
        y.data_ptr(), bias.data_ptr(), out.data_ptr(), batch, hc, wc,
        channels, _DTYPES[y.dtype], _native.stream_ptr(y.device))
    _native.check("relu_maxpool", code)
    if batch * (hc // 2) and wc // 2:  # nothing is launched for no output
        relu_maxpool_cuda.launches += 1
    return out


relu_maxpool_cuda.launches = 0


def relu_maxpool_backward_reference(g: torch.Tensor, y: torch.Tensor,
                                    bias: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel C: pooled cotangent ``g [B, Hp, Wp, C]``,
    raw conv output ``y [B, Hc, Wc, C]``, ``bias [C]`` -> ``(dz`` like
    ``y``, ``db [C]`` f32``)``. The ReLU gate and ``db`` are taken on the
    pooled side; each window's cotangent goes to the first position, in
    row-major order, whose ``cast(relu(y + b))`` equals the window's max."""
    batch, hc, wc, channels = y.shape
    hp, wp = hc // 2, wc // 2
    z = torch.relu(y[:, :2 * hp, :2 * wp].float() + bias.float()).to(y.dtype)
    # [B, Hp, Wp, C, 4]: the window's positions in row-major order.
    windows = z.reshape(batch, hp, 2, wp, 2, channels).permute(
        0, 1, 3, 5, 2, 4).reshape(batch, hp, wp, channels, 4)
    pooled = windows.amax(dim=-1)
    g_gated = (g * (pooled > 0)).to(y.dtype)
    db = g_gated.float().sum(dim=(0, 1, 2))
    is_max = windows == pooled.unsqueeze(-1)
    taken = torch.zeros_like(pooled, dtype=torch.bool)
    first = []
    for position in is_max.unbind(dim=-1):
        first.append(position & ~taken)
        taken = taken | position
    first = torch.stack(first, dim=-1)
    routed = (first * g_gated.unsqueeze(-1)).reshape(
        batch, hp, wp, channels, 2, 2).permute(0, 1, 4, 2, 5, 3)
    dz = torch.zeros_like(y)
    dz[:, :2 * hp, :2 * wp] = routed.reshape(batch, 2 * hp, 2 * wp, channels)
    return dz, db


def relu_maxpool_backward_cuda(g: torch.Tensor, y: torch.Tensor,
                               bias: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C on ``y``'s CUDA device; raises on any input it does not
    take."""
    if y.dim() != 4 or bias.shape != (y.shape[-1],):
        raise ValueError(f"expected y [B,Hc,Wc,C] and bias [C]; got "
                         f"{tuple(y.shape)}, {tuple(bias.shape)}")
    batch, hc, wc, channels = y.shape
    if tuple(g.shape) != (batch, hc // 2, wc // 2, channels):
        raise ValueError(f"expected g {(batch, hc // 2, wc // 2, channels)} "
                         f"for y {tuple(y.shape)}; got {tuple(g.shape)}")
    if not y.is_cuda or bias.device != y.device or g.device != y.device:
        raise ValueError(f"g, y and bias must be CUDA tensors on one device; "
                         f"got {g.device}, {y.device}, {bias.device}")
    if (y.dtype not in _DTYPES or g.dtype != y.dtype
            or bias.dtype != torch.float32):
        raise ValueError(f"g and y must share a dtype in {list(_DTYPES)} and "
                         f"bias be f32; got {g.dtype}, {y.dtype}, {bias.dtype}")
    if not (g.is_contiguous() and y.is_contiguous() and bias.is_contiguous()):
        raise ValueError("g, y and bias must be contiguous (NHWC)")
    if channels * 4 > _MAX_SHARED_BYTES:
        raise ValueError(f"{channels} channels do not fit the kernel's "
                         "shared memory")
    if g.numel() == 0:  # no window: nothing to route, nothing is launched
        return torch.zeros_like(y), torch.zeros_like(bias)
    lib = _native.library()
    dz = torch.empty_like(y)
    db = torch.empty(channels, dtype=torch.float32, device=y.device)
    blocks = lib.vqa_relu_maxpool_backward_blocks(batch, hc)
    partial = torch.empty(blocks, channels, dtype=torch.float32,
                          device=y.device)
    code = lib.vqa_relu_maxpool_backward(
        g.data_ptr(), y.data_ptr(), bias.data_ptr(), dz.data_ptr(),
        db.data_ptr(), partial.data_ptr(), batch, hc, wc, channels,
        _DTYPES[y.dtype], _native.stream_ptr(y.device))
    _native.check("relu_maxpool_backward", code)
    # Two grids: the routing with its per-block bias sums, then the sum
    # of those partials.
    relu_maxpool_backward_cuda.launches += 2
    return dz, db


relu_maxpool_backward_cuda.launches = 0


class ReluMaxPool(torch.autograd.Function):
    """``(y, bias, plain) -> pooled``: kernel 2 forward, kernel C backward
    (their plain versions for a CPU tensor or ``plain=True``). Saves the
    raw conv output; the cotangent of ``bias`` is rounded to ``y``'s
    dtype, as the JAX package's is."""

    @staticmethod
    def forward(ctx, y, bias, plain):
        plain = plain or y.device.type == "cpu"
        ctx.plain = plain
        ctx.save_for_backward(y, bias)
        bias = bias.float()
        return (relu_maxpool_reference(y, bias) if plain
                else relu_maxpool_cuda(y, bias))

    @staticmethod
    def backward(ctx, g):
        y, bias = ctx.saved_tensors
        backward = (relu_maxpool_backward_reference if ctx.plain
                    else relu_maxpool_backward_cuda)
        dz, db = backward(g.contiguous(), y, bias.float())
        return dz, db.to(y.dtype).to(bias.dtype), None


def relu_maxpool(y: torch.Tensor, bias: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """Differentiable bias + ReLU + pool. Dispatch: a CPU tensor, or
    ``plain=True``, runs the plain versions; any other device runs
    kernels 2 and C, which raise where they cannot launch."""
    return ReluMaxPool.apply(y, bias, plain)


def conv_relu_pool_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, stride: int = 1
                             ) -> torch.Tensor:
    """The whole block in plain PyTorch, forward only (autograd through
    it gives the plain gradient, not the JAX package's tie routing)."""
    return relu_maxpool_reference(conv_nhwc(x, weight, stride), bias)


def conv_relu_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   stride: int = 1, plain: bool = False) -> torch.Tensor:
    """The block on the model's path: conv, then :func:`relu_maxpool`."""
    return relu_maxpool(conv_nhwc(x, weight, stride), bias, plain)
