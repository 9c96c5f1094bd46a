"""Conv(k, k, VALID) -> bias -> ReLU -> 2x2 maxpool blocks, NHWC.

Port of the eval branch of :func:`dl_vqa_tpu.ops.conv_fused.conv_relu_pool`
and of :func:`~dl_vqa_tpu.ops.conv_fused.conv_relu_pool_reference`. The
conv is ``F.conv2d`` without bias in ``channels_last`` memory, output in
the input's dtype, as the JAX package leaves it to XLA. Bias, ReLU and the
pool are kernel 2 (``csrc/relu_maxpool.cu``), which replaces
``dl_vqa_tpu/ops/conv_fused.py::_relu_pool_kernel`` and
``::_relu_pool_direct_kernel``.

Kernel 2, what bounds it on this card: nothing but memory traffic. It
reads the unpooled conv output once (512 x 222 x 222 x 64 bf16 = 3.2 GB
for conv0 at batch 512) and writes a quarter of it; the plain version
makes f32 copies of that tensor before it pools. The design reads each
input element once, one thread per output element with channels fastest
so that a warp's loads are contiguous, and applies bias, ReLU and the
cast after the max (they are monotone, so the bits are the same).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dl_vqa_tpu_torch.ops import _native

__all__ = ["conv_nhwc", "relu_maxpool_reference", "relu_maxpool_cuda",
           "relu_maxpool", "conv_relu_pool_reference", "conv_relu_pool"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def relu_maxpool(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Dispatch: a CPU tensor runs :func:`relu_maxpool_reference`; any
    other device runs kernel 2, which raises where it cannot launch."""
    if y.device.type == "cpu":
        return relu_maxpool_reference(y, bias)
    return relu_maxpool_cuda(y, bias)


def conv_relu_pool_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, stride: int = 1
                             ) -> torch.Tensor:
    """The whole block in plain PyTorch."""
    return relu_maxpool_reference(conv_nhwc(x, weight, stride), bias)


def conv_relu_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """The block on the serving path: conv, then :func:`relu_maxpool`."""
    return relu_maxpool(conv_nhwc(x, weight, stride), bias)
