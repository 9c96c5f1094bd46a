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

Kernel 2 has two more output modes for the quantized serving modes, which
the JAX package computes in XLA: ``e4m3`` for the f8 store
(:func:`conv_relu_pool_quantstore`: ``relu(f32(y) + b)`` cast to e4m3 with
no saturation, NaN above :data:`E4M3_OVERFLOW` as JAX's cast gives it,
widened back; the straight-through backward is kernel C, as for the
unquantized block) and ``int8`` for the int8 stem's first block
(:func:`quantize_relu_pool_reference`, called by
``ops/conv_int8.py::quantize_relu_pool``). Both take the max first too.
The three modes are one custom op, ``vqa::relu_maxpool(y, bias, mode,
s_out)``: kernel 2 on CUDA tensors, the mode's plain version on CPU
tensors.

Kernel C, what bounds it: memory traffic again. It reads the raw conv
output and the pooled cotangent and writes ``dz`` of the conv output's
size (3.2 + 0.8 + 3.2 GB for conv0 at batch 512). The forward saves the
raw conv output, which the conv wrote anyway, and kernel C recomputes
``cast(relu(y + b))`` per element to decide ties as the JAX package does,
on the pooled values; saving those instead would cost one more 3.2 GB
write in the forward. The bias gradient is the pooled-side sum of the
gated cotangent, taken in the same pass. Where
:func:`pool_backward_vector_path` says so (the model's three conv
outputs among them) a thread makes one window for one 16-byte channel
vector; other shapes keep one thread a channel.

The fused blocks, which no default path takes (``fused=True``, or
``fused_ops=True`` on the model): kernel 6
(``csrc/conv_relu_pool_fused.cu``) replaces ``::_fused_kernel``, the conv
as tap GEMMs with bias, ReLU and the pool on the f32 accumulator, for
stride 1 and ``Cin >= 16``; kernel 7 (``csrc/conv_relu_pool_stem.cu``)
replaces ``::_stem_kernel`` for the small-``Cin`` stem, forward only as
its original; they are the custom ops ``vqa::conv_relu_pool_fused`` and
``vqa::conv_relu_pool_stem``. Neither writes the conv output, so neither
rounds it:
their plain version is :func:`conv_relu_pool_fused_reference`, which in
bf16 differs from :func:`conv_relu_pool_reference` by that one rounding
(the JAX package has the same pair, ``_fused_kernel`` against
``conv_relu_pool_reference``). Operations bound kernel 6 on this card
(0.88 TFLOP for conv1 at batch 512) and memory traffic kernel 7 (0.15 GB
in, 0.81 GB out for conv0); the source notes say what each design does.
In bf16 kernel 7 runs on ``mma.sync`` where :func:`stem_mma_path` says
so, with its weights packed by :func:`pack_stem_weight`;
:func:`stem_mma_emulation` is that arithmetic in plain PyTorch.
In bf16 kernel 6 reads its weights by wgmma descriptors:
:func:`pack_conv_weight` writes them in that layout, and
:func:`fused_plan` mirrors the tiling the kernel chooses (its C entry
``vqa_conv_relu_pool_fused_plan`` reports its own, which the card tests
hold to this one).
:class:`ConvReluPoolFused` gives kernel 6 the gradients of the unfused
block, as ``_fused_bwd`` does: it recomputes the conv output with the
library call and hands it to kernel C.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dl_vqa_tpu_torch.ops import _native
from dl_vqa_tpu_torch.ops.wgmma_layout import ATOM, swizzle_index

__all__ = ["conv_nhwc", "relu_maxpool_reference", "relu_maxpool_cuda",
           "relu_maxpool_e4m3_reference", "relu_maxpool_e4m3_cuda",
           "relu_maxpool_launch", "ReluMaxPoolQuantStore", "f32",
           "maxpool_2x2", "quantize_pool", "quantize_relu_pool_reference",
           "quantize_relu_pool_cuda",
           "conv_relu_pool_quantstore", "E4M3_OVERFLOW",
           "relu_maxpool_backward_reference", "relu_maxpool_backward_cuda",
           "ReluMaxPool", "relu_maxpool", "conv_relu_pool_reference",
           "conv_relu_pool_fused_reference", "conv_relu_pool_fused_cuda",
           "ConvReluPoolFused", "conv_relu_pool_stem_reference",
           "conv_relu_pool_stem_cuda", "conv_relu_pool_stem",
           "conv_relu_pool", "FUSED_MIN_CIN", "FusedPlan", "fused_plan",
           "pack_conv_weight", "pool_backward_vector_path",
           "pool_backward_vector_split", "pool_backward_vector_stores",
           "stem_mma_path", "stem_k_offsets", "pack_stem_weight",
           "stem_mma_emulation"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Kernel 2's output modes (csrc/relu_maxpool.cu).
_POOL_MODES = {"compute": 0, "e4m3": 1, "int8": 2}
# The largest value JAX's f32 -> float8_e4m3fn cast keeps finite: 464 rounds
# to 448, anything above it becomes NaN (float8_e4m3fn has no infinity).
E4M3_OVERFLOW = 464.0
_MAX_SHARED_BYTES = 32 * 1024  # kernel C keeps one f32 per channel there
FUSED_MIN_CIN = 16  # narrower inputs go to the stem op, not to kernel 6
SMEM_PER_BLOCK = 232448  # bytes of shared memory a Hopper block may use
_ARRANGEMENTS = ((4, 1), (2, 2), (1, 4))  # warp rows x columns of a tile
_WARPGROUPS = 2   # kernel 6's tile streams a block
_STREAM_TILES = 4  # its tiles a block step where the weights stream
_PAD = 8          # values after each staged pixel (bank spread)
# Kernel C's vector kernel (csrc/relu_maxpool_backward.cu): threads a block
# (kThreads), bytes of a thread's channel vector (kVectorBytes), pooled
# pixels a call may have (kMaxVectorPixels).
POOL_BACKWARD_THREADS = 256
POOL_BACKWARD_VECTOR_BYTES = 16
POOL_BACKWARD_MAX_PIXELS = 2 ** 31
# Kernel 7's tensor-core kernel (csrc/conv_relu_pool_stem.cu): the largest
# padded K (kStemMaxKSteps k steps of 16) and filter row (kStemMaxRowTaps).
STEM_MAX_KSTEPS = 6
STEM_MAX_ROW_TAPS = 16


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


def relu_maxpool_e4m3_reference(y: torch.Tensor, bias: torch.Tensor
                                ) -> torch.Tensor:
    """Plain version of kernel 2's e4m3 mode, the pool of
    ``conv_relu_pool_quantstore``: ``relu(f32(y) + bias)`` cast to e4m3,
    pooled and widened back to ``y``'s dtype. ``.to(float8_e4m3fn)``
    saturates where JAX's cast gives NaN (every value above
    :data:`E4M3_OVERFLOW`; at or below it the two agree), so those become
    NaN here, and the pool carries them as JAX's max does."""
    batch, hc, wc, channels = y.shape
    hp, wp = hc // 2, wc // 2
    z = torch.relu(y[:, :2 * hp, :2 * wp].float() + bias.float())
    q = z.to(torch.float8_e4m3fn).float()
    q = torch.where(z > E4M3_OVERFLOW, float("nan"), q)
    return q.reshape(batch, hp, 2, wp, 2, channels).amax(dim=(2, 4)).to(
        y.dtype)


def relu_maxpool_launch(y: torch.Tensor, bias: torch.Tensor, mode: str,
                        scale: float = 1.0) -> torch.Tensor:
    """Kernel 2 in one of its output modes (``compute``, ``e4m3``,
    ``int8``; ``scale`` is the int8 mode's ``127 / s_out``, rounded to f32
    here) on ``y``'s CUDA device; raises on any input it does not take.
    The int8 mode writes int8, the others ``y``'s dtype. Counts nothing:
    the wrappers of the modes do."""
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
    out = torch.empty(batch, hc // 2, wc // 2, channels,
                      dtype=torch.int8 if mode == "int8" else y.dtype,
                      device=y.device)
    code = lib.vqa_relu_maxpool(
        y.data_ptr(), bias.data_ptr(), out.data_ptr(), batch, hc, wc,
        channels, _DTYPES[y.dtype], _POOL_MODES[mode], scale,
        _native.stream_ptr(y.device))
    _native.check("relu_maxpool", code)
    return out


def relu_maxpool_cuda(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel 2 on ``y``'s CUDA device; raises on any input it does not
    take."""
    out = relu_maxpool_launch(y, bias, "compute")
    if out.numel():  # nothing is launched for no output
        relu_maxpool_cuda.launches += 1
    return out


relu_maxpool_cuda.launches = 0


def relu_maxpool_e4m3_cuda(y: torch.Tensor, bias: torch.Tensor
                           ) -> torch.Tensor:
    """Kernel 2's e4m3 mode on ``y``'s CUDA device; raises on any input it
    does not take."""
    out = relu_maxpool_launch(y, bias, "e4m3")
    if out.numel():
        relu_maxpool_e4m3_cuda.launches += 1
    return out


relu_maxpool_e4m3_cuda.launches = 0


def f32(value: float) -> float:
    """A Python double rounded once to f32 (as JAX rounds a weakly typed
    constant against an f32 array), returned as the exact double."""
    return float(np.float32(value))


def maxpool_2x2(q: torch.Tensor) -> torch.Tensor:
    """2x2/2 floor max pool of ``[B, Hc, Wc, C]``."""
    batch, hc, wc, channels = q.shape
    hp, wp = hc // 2, wc // 2
    return q[:, :2 * hp, :2 * wp].reshape(batch, hp, 2, wp, 2,
                                          channels).amax(dim=(2, 4))


def quantize_pool(z: torch.Tensor, s_out: float) -> torch.Tensor:
    """``clip(round(relu(z) * (127 / s_out)), 0, 127)`` as int8, pooled."""
    q = torch.clamp(torch.round(torch.relu(z) * f32(127.0 / s_out)), 0, 127)
    return maxpool_2x2(q.to(torch.int8))


def quantize_relu_pool_reference(y: torch.Tensor, bias: torch.Tensor,
                                 s_out: float) -> torch.Tensor:
    """Plain version of kernel 2's int8 mode: ``clip(round(relu(f32(y) +
    bias) * (127 / s_out)), 0, 127)`` as int8, then the pool; ``y`` the conv
    output without its bias."""
    return quantize_pool(y.float() + bias.float(), s_out)


def quantize_relu_pool_cuda(y: torch.Tensor, bias: torch.Tensor,
                            s_out: float) -> torch.Tensor:
    """Kernel 2's int8 mode on ``y``'s CUDA device; raises on any input it
    does not take."""
    out = relu_maxpool_launch(y, bias.float().contiguous(), "int8",
                              f32(127.0 / s_out))
    if out.numel():
        quantize_relu_pool_cuda.launches += 1
    return out


quantize_relu_pool_cuda.launches = 0


def _relu_maxpool_plain(y, bias, mode, s_out):
    if mode == "int8":
        return quantize_relu_pool_reference(y, bias, s_out)
    if mode == "e4m3":
        return relu_maxpool_e4m3_reference(y, bias)
    return relu_maxpool_reference(y, bias)


def _relu_maxpool_kernel(y, bias, mode, s_out):
    if mode == "int8":
        return quantize_relu_pool_cuda(y, bias, s_out)
    if mode == "e4m3":
        return relu_maxpool_e4m3_cuda(y, bias)
    return relu_maxpool_cuda(y, bias)


def _relu_maxpool_fake(y, bias, mode, s_out):
    batch, hc, wc, channels = y.shape
    return y.new_empty(batch, hc // 2, wc // 2, channels,
                       dtype=torch.int8 if mode == "int8" else y.dtype)


# mode: "compute" (the output in y's dtype), "e4m3" or "int8" (s_out, the
# block's calibrated amax, is read by the int8 mode only).
_native.define_op(
    "relu_maxpool", "(Tensor y, Tensor bias, str mode, float s_out) -> Tensor",
    _relu_maxpool_plain, _relu_maxpool_kernel, _relu_maxpool_fake)


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


def pool_backward_vector_path(batch: int, hc: int, wc: int, channels: int,
                              dtype: torch.dtype, pointers=()) -> bool:
    """Whether kernel C runs its vector kernel: the mirror of
    ``vector_path`` in ``csrc/relu_maxpool_backward.cu``. C is a multiple of
    the 16-byte vector (8 bf16 or 4 f32 channels) and its count of vectors
    divides the block's 256 threads, so that a thread's vector never changes
    across its grid-stride steps; the pooled pixels fit 31 bits; and every
    pointer of ``g``, ``y``, ``bias`` and ``dz`` sits on a 16-byte
    boundary."""
    if dtype not in _DTYPES or channels <= 0:
        return False
    vec = POOL_BACKWARD_VECTOR_BYTES // dtype.itemsize
    return (channels % vec == 0
            and POOL_BACKWARD_THREADS % (channels // vec) == 0
            and batch * (hc // 2) * (wc // 2) < POOL_BACKWARD_MAX_PIXELS
            and all(p % POOL_BACKWARD_VECTOR_BYTES == 0 for p in pointers))


def pool_backward_vector_split(batch: int, hc: int, wc: int, channels: int,
                               dtype: torch.dtype, blocks: int) -> dict:
    """The vector kernel's work as it splits it over ``blocks`` blocks:
    ``(block, thread) -> [(pooled pixel, first channel), ...]``, the windows
    each thread makes in its grid-stride order. A block takes 256 / (C /
    vector) consecutive pooled pixels a step, their vectors fastest."""
    vec = POOL_BACKWARD_VECTOR_BYTES // dtype.itemsize
    vectors = channels // vec
    per_step = POOL_BACKWARD_THREADS // vectors
    pixels = batch * (hc // 2) * (wc // 2)
    split = {}
    for block in range(blocks):
        for thread in range(POOL_BACKWARD_THREADS):
            split[block, thread] = [
                (p, thread % vectors * vec)
                for p in range(block * per_step + thread // vectors, pixels,
                               blocks * per_step)]
    return split


def pool_backward_vector_stores(p: int, ch: int, hc: int, wc: int,
                                channels: int) -> list:
    """The offsets in ``dz`` (elements of ``[B, Hc, Wc, C]``) of the 16-byte
    vectors that the vector kernel's window at pooled pixel ``p`` and
    channel ``ch`` writes: its four positions, then the zeros of the odd
    last column beside the row's last window and of the odd last row below
    the last row of windows."""
    hp, wp = hc // 2, wc // 2
    row, j = divmod(p, wp)
    b, i = divmod(row, hp)
    in_row = wc * channels
    at = ((b * hc + 2 * i) * wc + 2 * j) * channels + ch
    stores = [at, at + channels, at + in_row, at + in_row + channels]
    last_col = wc % 2 == 1 and j == wp - 1
    if last_col:
        stores += [at + 2 * channels, at + in_row + 2 * channels]
    if hc % 2 == 1 and i == hp - 1:
        below = at + 2 * in_row
        stores += [below, below + channels]
        if last_col:
            stores.append(below + 2 * channels)
    return stores


def relu_maxpool_backward_cuda(g: torch.Tensor, y: torch.Tensor,
                               bias: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C on ``y``'s CUDA device; raises on any input it does not
    take. ``launches`` counts its grids (two a call), ``launches_vector``
    those of calls that ran the vector kernel."""
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
    call = (g.data_ptr(), y.data_ptr(), bias.data_ptr(), dz.data_ptr(),
            batch, hc, wc, channels, _DTYPES[y.dtype])
    blocks = lib.vqa_relu_maxpool_backward_blocks(*call)
    if blocks <= 0:
        raise RuntimeError("relu_maxpool_backward: the device's SM count "
                           "could not be read")
    vector = bool(lib.vqa_relu_maxpool_backward_vector(*call))
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
    if vector:
        relu_maxpool_backward_cuda.launches_vector += 2
    return dz, db


relu_maxpool_backward_cuda.launches = 0
relu_maxpool_backward_cuda.launches_vector = 0


class ReluMaxPool(torch.autograd.Function):
    """``(y, bias, plain) -> pooled``: ``vqa::relu_maxpool`` forward,
    kernel C backward (their plain versions for a CPU tensor or
    ``plain=True``; ``plain=True`` never calls the op). Saves the raw conv
    output; the cotangent of ``bias`` is rounded to ``y``'s dtype, as the
    JAX package's is."""

    @staticmethod
    def forward(ctx, y, bias, plain):
        ctx.plain = plain or y.device.type == "cpu"
        ctx.save_for_backward(y, bias)
        bias = bias.float()
        return (relu_maxpool_reference(y, bias) if plain
                else torch.ops.vqa.relu_maxpool(y, bias, "compute", 1.0))

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
    ``plain=True``, runs the plain versions; a CUDA tensor runs kernels 2
    and C, which raise where they cannot launch."""
    return ReluMaxPool.apply(y, bias, plain)


class ReluMaxPoolQuantStore(ReluMaxPool):
    """``(y, bias, plain) -> pooled`` with the activations stored in e4m3:
    ``vqa::relu_maxpool``'s e4m3 mode forward (its plain version for a CPU
    tensor or ``plain=True``). The backward is :class:`ReluMaxPool`'s,
    kernel C on the saved raw conv output: the exact gradient of the
    unquantized block, the straight-through estimator of
    ``_quantstore_bwd`` in the JAX package."""

    @staticmethod
    def forward(ctx, y, bias, plain):
        ctx.plain = plain or y.device.type == "cpu"
        ctx.save_for_backward(y, bias)
        bias = bias.float()
        return (relu_maxpool_e4m3_reference(y, bias) if plain
                else torch.ops.vqa.relu_maxpool(y, bias, "e4m3", 1.0))


def conv_relu_pool_quantstore(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, stride: int = 1,
                              plain: bool = False) -> torch.Tensor:
    """Port of ``conv_relu_pool_quantstore`` with ``float8_e4m3fn``: the
    conv (cuDNN, output in ``x``'s dtype), then ``pool(cast_e4m3(relu(
    f32(conv) + b)))`` cast back to ``x``'s dtype; gradients by the
    straight-through estimator (:class:`ReluMaxPoolQuantStore`), the conv's
    by autograd from the same conv output, which is not recomputed."""
    return ReluMaxPoolQuantStore.apply(conv_nhwc(x, weight, stride), bias,
                                       plain)


def conv_relu_pool_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, stride: int = 1
                             ) -> torch.Tensor:
    """The whole block in plain PyTorch, forward only (autograd through
    it gives the plain gradient, not the JAX package's tie routing)."""
    return relu_maxpool_reference(conv_nhwc(x, weight, stride), bias)


def conv_relu_pool_fused_reference(x: torch.Tensor, weight: torch.Tensor,
                                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels 6 and 7: the stride-1 VALID conv of
    operands rounded to ``x``'s dtype with f32 sums, then bias, ReLU and
    the 2x2 floor max pool in f32, then one cast. ``x [B, H, W, Cin]``,
    torch-layout ``weight [Cout, Cin, k, k]`` -> ``[B, (H - k + 1) // 2,
    (W - k + 1) // 2, Cout]``."""
    w = weight.to(x.dtype).float().contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w)
    y = torch.relu_(y + bias.float()[None, :, None, None])
    return F.max_pool2d(y, 2).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check_fused_inputs(x, weight, bias, what: str) -> None:
    if (x.dim() != 4 or weight.dim() != 4 or weight.shape[1] != x.shape[-1]
            or weight.shape[2] != weight.shape[3]
            or bias.shape != (weight.shape[0],)):
        raise ValueError(f"expected x [B,H,W,Cin], weight [Cout,Cin,k,k] and "
                         f"bias [Cout]; got {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if not x.is_cuda or weight.device != x.device or bias.device != x.device:
        raise ValueError(f"{what} takes CUDA tensors on one device; got "
                         f"{x.device}, {weight.device}, {bias.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be one of {list(_DTYPES)}; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    if x.shape[1] < weight.shape[2] or x.shape[2] < weight.shape[2]:
        raise ValueError(f"a {weight.shape[2]}x{weight.shape[2]} filter does "
                         f"not fit an input of {tuple(x.shape[1:3])}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the launch grid (65535)")


def _pooled_empty(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The output of kernel 6 or 7, uninitialised (also their ops' fake
    implementation)."""
    cout, _, k, _ = weight.shape
    return x.new_empty(x.shape[0], (x.shape[1] - k + 1) // 2,
                       (x.shape[2] - k + 1) // 2, cout)


class FusedPlan(NamedTuple):
    """Kernel 6's bf16 tiling. A warpgroup's tile is ``warp_rows`` x ``4
    warp_cols`` pool windows (64 conv positions); a block owns
    ``channels`` output channels, with their weights resident in shared
    memory or, where those do not fit (``stream``), staged a filter row a
    step for four tiles at once; a step stages ``ck`` input channels of a
    tile's window."""
    warp_rows: int
    warp_cols: int
    channels: int
    ck: int
    shared: int        # bytes of shared memory a block asks for
    tiles_y: int       # tiles of one image
    tiles_x: int
    masked: float      # share of the computed windows outside the output
    stream: bool = False


def _shared_bytes(k: int, rows: int, cols: int, atoms: int, channels: int,
                  ck: int, stream: bool) -> int:
    """Kernel 6's shared memory a block: resident, the weights and two
    stages of each warpgroup's input window; streamed, two stages of one
    filter row's weights and two of the block step's four windows; and
    1024 bytes to align the weights."""
    window = (2 * rows + k - 1) * (8 * cols + k - 1) * (ck + _PAD) * 2
    if stream:
        return 2 * k * channels * 128 + 2 * _STREAM_TILES * window + 1024
    return k * k * atoms * channels * 128 + 2 * _WARPGROUPS * window + 1024


def fused_plan(h: int, w: int, cin: int, cout: int, k: int
               ) -> Optional[FusedPlan]:
    """The tiling ``csrc/conv_relu_pool_fused.cu::make_plan`` takes for a
    bf16 call, or None where not even streamed weights fit a block. The
    tile arrangement masks the fewest windows at this output size (ties to
    the squarer tile). Resident weights (for all taps, Cin padded to
    64-channel atoms) come first: ``ck`` the widest of 64, 48, 32, 16
    dividing Cin, the slice the widest of 128, 64, 32 dividing Cout that
    fits with two warpgroups' two input stages (``ck`` + 8 values a
    pixel). Else the weights stream, with the widest slice, then the widest
    ``ck``, that fit. The plan does not depend on the batch, so neither do
    a pixel's bits."""
    hp, wp = (h - k + 1) // 2, (w - k + 1) // 2
    if k < 1 or cin % 16 or cout % 32 or hp <= 0 or wp <= 0:
        return None
    best = None
    for rows, cols in _ARRANGEMENTS:
        tiles_y, tiles_x = -(-hp // rows), -(-wp // (4 * cols))
        if best is None or tiles_y * tiles_x < best[2] * best[3]:
            best = (rows, cols, tiles_y, tiles_x)
    rows, cols, tiles_y, tiles_x = best
    cks = [c for c in (64, 48, 32, 16) if cin % c == 0]
    atoms = -(-cin // ATOM)
    masked = 1.0 - hp * wp / (tiles_y * tiles_x * 16)
    slices = [n for n in (128, 64, 32) if cout % n == 0]
    choices = [(n, cks[0], False) for n in slices] + \
        [(n, ck, True) for n in slices for ck in cks]
    for channels, ck, stream in choices:
        shared = _shared_bytes(k, rows, cols, atoms, channels, ck, stream)
        if shared <= SMEM_PER_BLOCK:
            return FusedPlan(rows, cols, channels, ck, shared, tiles_y,
                             tiles_x, masked, stream)
    return None


@functools.lru_cache(maxsize=None)
def _conv_pack_index(cout: int, cin: int, k: int,
                     device: torch.device) -> torch.Tensor:
    """For each value of the packed weight, its offset in ``[Cout, Cin, k,
    k]`` (Cin a multiple of 64)."""
    per_tap = swizzle_index(cout, cin, device)  # offsets n Cin + ci
    taps = torch.arange(k * k, device=device)[:, None]
    return (per_tap[None, :] * (k * k) + taps).reshape(-1)


def pack_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """Torch-layout ``weight [Cout, Cin, k, k]`` -> kernel 6's bf16 operand
    ``[k * k, ceil(Cin / 64), Cout, 64]``: per tap, the ``[Cout, Cin]``
    matrix K-major and swizzled (``ops/wgmma_layout.py``), Cin padded with
    zeros to whole 64-channel atoms, so that a slice of output channels of
    one tap is one run of memory. One gather (and a pad where Cin is no
    multiple of 64)."""
    cout, cin, k, _ = weight.shape
    if cin % ATOM:
        weight = F.pad(weight, (0, 0, 0, 0, 0, -cin % ATOM))
    index = _conv_pack_index(cout, weight.shape[1], k, weight.device)
    return torch.take(weight.contiguous(), index).reshape(
        k * k, -(-cin // ATOM), cout, ATOM)


def conv_relu_pool_fused_cuda(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, stride: int = 1
                              ) -> torch.Tensor:
    """Kernel 6 on ``x``'s CUDA device; raises on any input it does not
    take. The weight arrives in torch layout and is repacked here, once a
    call, in ``x``'s dtype: for f32 to ``[k * k, Cin, Cout]``, for bf16 by
    :func:`pack_conv_weight`."""
    _check_fused_inputs(x, weight, bias, "conv_relu_pool_fused_cuda")
    cout, cin, k, _ = weight.shape
    if stride != 1:
        raise ValueError(f"kernel 6 takes stride 1; got {stride}")
    if cin < FUSED_MIN_CIN:
        raise ValueError(f"kernel 6 takes Cin >= {FUSED_MIN_CIN}; got {cin} "
                         "(the stem op takes narrow inputs)")
    if x.dtype == torch.bfloat16 and (cin % 16 or cout % 32):
        raise ValueError(f"in bf16 kernel 6 takes Cin a multiple of 16 and "
                         f"Cout a multiple of 32; got {cin}, {cout}")
    if cout % 8:
        raise ValueError(f"kernel 6 takes Cout a multiple of 8; got {cout}")
    if x.dtype == torch.bfloat16 and fused_plan(x.shape[1], x.shape[2], cin,
                                                cout, k) is None:
        raise ValueError(f"not even one filter row of kernel 6's weights "
                         f"fits a block's shared memory at Cin={cin}, k={k}")
    lib = _native.library()
    if x.dtype == torch.bfloat16:
        packed = pack_conv_weight(weight.detach().to(x.dtype))
    else:
        packed = weight.detach().permute(2, 3, 1, 0).to(x.dtype).contiguous()
    out = _pooled_empty(x, weight)
    bias32 = bias.detach().float().contiguous()
    code = lib.vqa_conv_relu_pool_fused(
        x.data_ptr(), packed.data_ptr(), bias32.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], x.shape[2], cin, cout, k,
        _DTYPES[x.dtype], _native.stream_ptr(x.device))
    _native.check("conv_relu_pool_fused", code)
    if out.numel():  # the C entry launches nothing for no output
        conv_relu_pool_fused_cuda.launches += 1
    return out


conv_relu_pool_fused_cuda.launches = 0

_native.define_op(
    "conv_relu_pool_fused", "(Tensor x, Tensor weight, Tensor bias) -> Tensor",
    conv_relu_pool_fused_reference, conv_relu_pool_fused_cuda, _pooled_empty)


class ConvReluPoolFused(torch.autograd.Function):
    """``(x, weight, bias, plain) -> pooled``: ``vqa::conv_relu_pool_fused``
    forward (its plain version with ``plain=True``). Backward: the exact
    gradients of the unfused block, as ``_fused_bwd`` of the JAX package
    takes them: the conv output is computed again by :func:`conv_nhwc`,
    kernel C routes the cotangent through pool and ReLU and sums ``db``,
    and the conv's own gradients follow. Saves ``x``, ``weight`` and
    ``bias``; no conv output lives between forward and backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, plain):
        ctx.plain = plain or x.device.type == "cpu"
        ctx.save_for_backward(x, weight, bias)
        if plain:
            return conv_relu_pool_fused_reference(x, weight, bias)
        return torch.ops.vqa.conv_relu_pool_fused(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(ctx.needs_input_grad[0])
            w_in = weight.detach().requires_grad_(ctx.needs_input_grad[1])
            y = conv_nhwc(x_in, w_in)
        backward = (relu_maxpool_backward_reference if ctx.plain
                    else relu_maxpool_backward_cuda)
        dz, db = backward(g.contiguous(), y.detach(), bias.float())
        inputs = [t for t in (x_in, w_in) if t.requires_grad]
        grads = dict(zip(map(id, inputs),
                         torch.autograd.grad(y, inputs, dz) if inputs else ()))
        return (grads.get(id(x_in)), grads.get(id(w_in)),
                db.to(y.dtype).to(bias.dtype), None)


# Plain version of kernel 7. The arithmetic of the stem op is that of the
# fused block (products of operands rounded to ``x``'s dtype, f32 sums,
# bias, ReLU, the max of a window's four conv positions, one cast).
conv_relu_pool_stem_reference = conv_relu_pool_fused_reference


def stem_mma_path(dtype: torch.dtype, cin: int, cout: int, k: int) -> bool:
    """Whether kernel 7 runs on the tensor cores: the mirror of
    ``stem_mma_plan`` in ``csrc/conv_relu_pool_stem.cu`` (bf16, Cout a
    multiple of 8, K = k * k * Cin padded to 16 at most 96, a filter row's
    k * Cin taps at most 16, so that its windows fit shared memory). Every
    other call runs on the FMA units."""
    return (dtype == torch.bfloat16 and k >= 1 and cin >= 1 and cout >= 8
            and cout % 8 == 0 and -(-k * k * cin // 16) <= STEM_MAX_KSTEPS
            and k * cin <= STEM_MAX_ROW_TAPS)


def stem_k_offsets(k: int, cin: int, row_values: int) -> torch.Tensor:
    """Kernel 7's offset of each K index (ordered di, dj, ci and padded to a
    multiple of 16) from a conv position's first value, in an NHWC window
    whose rows hold ``row_values`` values; -1 for the padding."""
    taps_row = k * cin
    kk = torch.arange(-(-k * taps_row // 16) * 16)
    return torch.where(kk < k * taps_row,
                       kk // taps_row * row_values + kk % taps_row, -1)


def _stem_fragment_index(ksteps: int, cout: int) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(k, n) of each value of the packed ``[ksteps, Cout / 8, 32, 4]``
    weight: lane l of an 8-channel tile holds channel ``l / 4`` at k = 2 (l
    % 4) and the next (its first register, b0) and at those + 8 (b1)."""
    s = torch.arange(ksteps)[:, None, None, None]
    nt = torch.arange(cout // 8)[None, :, None, None]
    lane = torch.arange(32)[None, None, :, None]
    j = torch.arange(4)[None, None, None, :]
    k = 16 * s + 2 * (lane % 4) + j % 2 + 8 * (j // 2)
    n = 8 * nt + lane // 4
    return k.expand(ksteps, cout // 8, 32, 4), n.expand(ksteps, cout // 8,
                                                          32, 4)


@functools.lru_cache(maxsize=None)
def _stem_pack_index(cout: int, cin: int, k: int,
                     device: torch.device) -> torch.Tensor:
    """For each value of the packed weight, its offset in ``[Cout, Cin, k,
    k]`` with one zero appended, which the K padding takes (built once a
    shape and device)."""
    taps = k * k * cin
    kk, n = _stem_fragment_index(-(-taps // 16), cout)
    di, rest = kk // (k * cin), kk % (k * cin)
    dj, ci = rest // cin, rest % cin
    offset = ((n * cin + ci) * k + di) * k + dj
    return torch.where(kk < taps, offset, cout * taps).reshape(-1).to(device)


def pack_stem_weight(weight: torch.Tensor) -> torch.Tensor:
    """Torch-layout ``weight [Cout, Cin, k, k]`` -> kernel 7's bf16 operand
    ``[K_pad / 16, Cout / 8, 32, 4]``: the ``[K_pad, Cout]`` matrix, K
    ordered (di, dj, ci) and padded with zero rows, in the order of
    ``mma.m16n8k16``'s B fragments, so that a lane reads its two registers
    for one k step and 8 channels as one 8-byte word. About 4 KB for the
    RGB stem. One gather from an index kept on the weight's device."""
    cout, cin, k, _ = weight.shape
    flat = F.pad(weight.reshape(-1).to(torch.bfloat16), (0, 1))
    index = _stem_pack_index(cout, cin, k, weight.device)
    return torch.take(flat, index).reshape(-(-k * k * cin // 16), cout // 8,
                                           32, 4)


def stem_mma_emulation(x: torch.Tensor, packed: torch.Tensor,
                       bias: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel 7's tensor-core arithmetic in plain PyTorch, for the tests:
    each conv position's A row gathered from the NHWC image by
    :func:`stem_k_offsets` (zero for the padding), the B matrix read back
    from ``packed`` by the fragment layout, an f32 product of the
    bf16-rounded operands, then the max of each window's four positions,
    bias, ReLU and one cast to ``x``'s dtype."""
    batch, h, w, cin = x.shape
    hp, wp = (h - k + 1) // 2, (w - k + 1) // 2
    offsets = stem_k_offsets(k, cin, w * cin).to(x.device)
    ksteps, tiles_n = packed.shape[:2]
    matrix = torch.zeros(16 * ksteps, 8 * tiles_n, dtype=torch.float32,
                         device=x.device)
    kk, n = _stem_fragment_index(ksteps, 8 * tiles_n)
    matrix[kk.to(x.device), n.to(x.device)] = packed.float()
    flat = x.to(torch.bfloat16).float().reshape(batch, -1)
    ys = torch.arange(2 * hp, device=x.device)[:, None]
    xs = torch.arange(2 * wp, device=x.device)[None, :]
    base = (ys * w * cin + xs * cin).reshape(-1, 1)  # [positions, 1]
    index = (base + offsets.clamp(min=0)).reshape(-1)
    rows = flat[:, index].reshape(batch, -1, offsets.numel())
    rows = rows * (offsets >= 0)
    conv = (rows @ matrix).reshape(batch, hp, 2, wp, 2, -1)
    pooled = conv.amax(dim=(2, 4)) + bias.float()
    return torch.relu(pooled).to(x.dtype)


def conv_relu_pool_stem_cuda(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """Kernel 7 on ``x``'s CUDA device; raises on any input it does not
    take. The weight arrives in torch layout and is repacked here, once a
    call: for the tensor-core kernel by :func:`pack_stem_weight`, else to
    f32 ``[k, k, Cin, Cout]`` holding values rounded to ``x``'s dtype.
    ``launches`` counts its grids, ``launches_mma`` those on the tensor
    cores."""
    _check_fused_inputs(x, weight, bias, "conv_relu_pool_stem_cuda")
    cout, cin, k, _ = weight.shape
    if cout % 8:
        raise ValueError(f"kernel 7 takes Cout a multiple of 8; got {cout}")
    lib = _native.library()
    mma = bool(lib.vqa_conv_relu_pool_stem_mma(cin, cout, k,
                                                _DTYPES[x.dtype]))
    if mma:
        packed = pack_stem_weight(weight.detach())
    else:
        packed = weight.detach().permute(2, 3, 1, 0).to(x.dtype).float(
            ).contiguous()
    out = _pooled_empty(x, weight)
    bias32 = bias.detach().float().contiguous()
    code = lib.vqa_conv_relu_pool_stem(
        x.data_ptr(), packed.data_ptr(), bias32.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], x.shape[2], cin, cout, k,
        _DTYPES[x.dtype], _native.stream_ptr(x.device))
    _native.check("conv_relu_pool_stem", code)
    if out.numel():
        conv_relu_pool_stem_cuda.launches += 1
        if mma:
            conv_relu_pool_stem_cuda.launches_mma += 1
    return out


conv_relu_pool_stem_cuda.launches = 0
conv_relu_pool_stem_cuda.launches_mma = 0

_native.define_op(
    "conv_relu_pool_stem", "(Tensor x, Tensor weight, Tensor bias) -> Tensor",
    conv_relu_pool_stem_reference, conv_relu_pool_stem_cuda, _pooled_empty)


def conv_relu_pool_stem(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, plain: bool = False
                        ) -> torch.Tensor:
    """The stem block (stride 1, small ``Cin``) with no conv output in
    memory, forward only as ``conv_relu_pool_stem`` of the JAX package: it
    raises where a gradient would be recorded. ``plain=True`` runs the
    plain version; otherwise ``vqa::conv_relu_pool_stem`` dispatches: a
    CPU tensor runs the plain version, a CUDA tensor kernel 7, which raises
    where it cannot launch."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError(
            "conv_relu_pool_stem is forward only: call it under "
            "torch.no_grad(), or use conv_relu_pool for gradients")
    if plain:
        return conv_relu_pool_stem_reference(x, weight, bias)
    return torch.ops.vqa.conv_relu_pool_stem(x, weight, bias)


def conv_relu_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   stride: int = 1, plain: bool = False,
                   fused: bool = False, f8_store: bool = False
                   ) -> torch.Tensor:
    """The block on the model's path: conv, then :func:`relu_maxpool`.
    ``f8_store=True`` stores the activations in e4m3
    (:func:`conv_relu_pool_quantstore`) and takes precedence over every
    other path, as ``store_dtype`` does in the JAX package. ``fused=True``
    sends stride 1 with ``Cin >= 16`` through kernel 6
    (:class:`ConvReluPoolFused`) and leaves everything else on that path,
    as ``use_pallas`` does in the JAX package; unlike there, nothing falls
    back for want of an accelerator."""
    if f8_store:
        return conv_relu_pool_quantstore(x, weight, bias, stride, plain)
    if fused and stride == 1 and x.shape[-1] >= FUSED_MIN_CIN:
        return ConvReluPoolFused.apply(x, weight, bias, plain)
    return relu_maxpool(conv_nhwc(x, weight, stride), bias, plain)
