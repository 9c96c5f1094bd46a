"""int8 (W8A8) CNN-stem serving mode: port of ``dl_vqa_tpu/ops/conv_int8.py``.

Every conv block stores its post-ReLU activations as int8 codes in
``[0, 127]`` (``y ~= y_q * s / 127`` with a static calibrated amax ``s`` a
block), and the blocks after the RGB stem run the convolution itself in
s8 x s8 -> s32. Weights are quantized here from the f32 parameters,
symmetric per output channel; the checkpoint format is unchanged. The
mode serves only: its scales are calibrated from trained weights, and the
model refuses it in training (``ModelConfig.check_ported``).

- conv0 stays a conv in the compute dtype (cuDNN), and its bias, ReLU,
  quantization and pool are kernel 2's int8 mode
  (:func:`quantize_relu_pool`, the op ``vqa::relu_maxpool`` of
  ``ops/conv_fused.py``, where the mode's plain version and wrapper
  live);
- every later block is kernel D, ``csrc/conv_relu_pool_int8.cu``
  (:func:`conv_relu_pool_w8a8`, the op ``vqa::conv_relu_pool_w8a8``:
  kernel D on CUDA tensors, its plain version on CPU tensors): the
  integer conv on ``wgmma`` m64nNk32 (s8 x s8 -> s32) with the weights
  resident in shared memory, or on ``mma.sync`` m16n8k32 for the shapes
  that kernel does not take (:func:`w8a8_plan` decides), with the
  requantizing epilogue, ReLU and the pool on the accumulators. The JAX
  package computes that block in XLA; PyTorch has no
  int8 convolution on CUDA, and an unfold plus an integer product would
  build a 3.5 GB im2col tensor at conv1. Its plain version computes the
  conv in float64 on the integer codes, where every sum is exact (|acc| <=
  127 * 127 * 1152 < 2^53), then the same f32 epilogue;
- the last block's codes are dequantized to the compute dtype.

Scale constants are computed as the JAX package computes them: ``127 /
s_out`` and ``s_in / 127`` in Python double, rounded to f32 once (JAX's
weak typing), and the per-channel ``w_scale * (s_in / 127)`` in f32. Where
XLA's jitted arithmetic, the way the JAX entry points run the model,
differs from its op-by-op arithmetic, the port follows the jitted one:
the weight scale ``amax / 127`` is ``amax * f32(1 / 127)`` (XLA turns the
division by a constant into a product with its reciprocal), and the
epilogue ``f32(acc) * mult + b`` rounds once, a fused multiply-add
(:func:`fma_f32`). ``tests/test_torch_quant.py`` holds both to jitted
JAX.
Calibration (:func:`calibrate_stem_scales`) runs the exact block in plain
PyTorch, as the JAX package runs it outside any kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from dl_vqa_tpu_torch.ops import _native
from dl_vqa_tpu_torch.ops.conv_fused import (
    SMEM_PER_BLOCK, conv_nhwc, f32, maxpool_2x2, quantize_pool,
    quantize_relu_pool_cuda, quantize_relu_pool_reference)
from dl_vqa_tpu_torch.ops.wgmma_layout import ATOM_BYTES, swizzle_index

__all__ = ["quantize_weights_per_channel", "quantize_relu_pool_reference",
           "fma_f32",
           "quantize_relu_pool_cuda", "quantize_relu_pool",
           "pack_int8_weight", "pack_int8_weight_wgmma", "WgmmaPlan",
           "MmaSyncPlan", "W8A8Plan",
           "w8a8_plan", "conv_relu_pool_w8a8_reference",
           "conv_relu_pool_w8a8_cuda", "conv_relu_pool_w8a8", "dequantize",
           "int8_stem_forward", "calibrate_stem_scales",
           "with_calibrated_scales", "f32"]

# Kernel D's mma.sync tiling (csrc/conv_relu_pool_int8.cu): output
# channels a block makes (the packed weight's channels are padded to it)
# and the depth of one mma.m16n8k32 step (Cin is padded to it; it is also
# the depth of one wgmma m64nNk32 step).
INT8_BLOCK_N = 128
INT8_K_STEP = 32
# Its wgmma kernel: the filter size it takes, output channels a block
# keeps resident (Cout is padded to them), input channels a stage may hold
# (widest first), bytes after each staged pixel (an ldmatrix phase's eight
# pixels then fall on eight bank groups) and its warpgroups a block.
W8A8_K = 3
W8A8_CHANNELS = 128
W8A8_STAGES = (128, 64, 32)
W8A8_PAD = 16
W8A8_WARPGROUPS = 2
_ARRANGEMENTS = ((4, 1), (2, 2), (1, 4))  # warp rows x columns of a tile


def fma_f32(a: torch.Tensor, m: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """``a * m + b`` of f32 values with one rounding to f32, as a fused
    multiply-add gives it: the product of two f32 values is exact in
    float64, so only the sum rounds there, then to f32 (a double rounding
    that can differ from a true FMA only where the float64 sum falls
    exactly halfway between two f32 values)."""
    return torch.addcmul(b.double(), a.double(), m.double()).float()


def quantize_weights_per_channel(w: torch.Tensor,
                                 amax: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a torch-layout weight, the
    output channel first (a conv's ``[Cout, Cin, k, k]``, a linear's
    ``[out, in]``) -> ``(w_q int8, scale f32 [Cout])`` with ``w ~= w_q *
    scale``; an all-zero channel gets scale 1. The JAX package's
    ``quantize_weights_per_channel`` (HWIO) and ``vit_int8._quantize_weight``
    (``[in, out]``) in one, as jitted XLA computes them: the scale is
    ``amax * f32(1 / 127)``, the codes ``round(w / scale)``. ``amax``:
    each channel's amax where ``w`` holds part of the channel (a
    row-parallel linear's columns)."""
    w32 = w.detach().float()
    if amax is None:
        amax = w32.abs().flatten(1).amax(dim=1)
    scale = torch.where(amax > 0, amax * f32(1.0 / 127.0),
                        torch.ones_like(amax))
    per_row = scale.reshape(-1, *[1] * (w.dim() - 1))
    w_q = torch.clamp(torch.round(w32 / per_row), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_relu_pool(y: torch.Tensor, bias: torch.Tensor, s_out: float,
                       plain: bool = False) -> torch.Tensor:
    """Port of ``quantize_relu_pool`` for a conv output ``y`` and its
    ``bias`` (added here in f32, as the JAX package adds it before the
    call). ``plain=True`` runs the plain version; otherwise
    ``vqa::relu_maxpool``'s int8 mode dispatches: a CPU tensor runs the
    plain version, a CUDA tensor kernel 2, which raises where it cannot
    launch."""
    if plain:
        return quantize_relu_pool_reference(y, bias, s_out)
    return torch.ops.vqa.relu_maxpool(y, bias, "int8", s_out)


@functools.lru_cache(maxsize=None)
def _pack_index(cout: int, cin: int, k: int,
                device: torch.device) -> torch.Tensor:
    """For each byte of the packed weight, its offset in ``[Cout, Cin, k,
    k]`` with one zero appended, which the padding takes (built once a
    shape and device)."""
    cin_pad = -(-cin // INT8_K_STEP) * INT8_K_STEP
    cout_pad = -(-cout // INT8_BLOCK_N) * INT8_BLOCK_N
    ksteps = k * k * cin_pad // INT8_K_STEP
    nt = torch.arange(cout_pad // 8)[:, None, None, None, None]
    step = torch.arange(ksteps)[None, :, None, None, None]
    lane = torch.arange(32)[None, None, :, None, None]
    reg = torch.arange(2)[None, None, None, :, None]
    e = torch.arange(4)[None, None, None, None, :]
    n = 8 * nt + lane // 4
    kk = INT8_K_STEP * step + 16 * reg + 4 * (lane % 4) + e
    tap, ci = kk // cin_pad, kk % cin_pad
    di, dj = tap // k, tap % k
    offset = ((n * cin + ci) * k + di) * k + dj
    valid = (n < cout) & (ci < cin)
    return torch.where(valid, offset, cout * cin * k * k).reshape(-1).to(
        device)


def pack_int8_weight(w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``w_q [Cout, Cin, k, k]`` -> kernel D's operand ``[Cout_pad /
    8, k * k * Cin_pad / 32, 32, 8]``: the ``[K, Cout]`` matrix, K ordered
    (di, dj, ci) with Cin padded to 32 and Cout to 128 by zeros, in the
    order of ``mma.m16n8k32``'s B fragments, so that a lane reads its two
    registers of one k step and one 8-channel tile as one 8-byte word."""
    cout, cin, k, _ = w_q.shape
    flat = F.pad(w_q.reshape(-1), (0, 1))
    index = _pack_index(cout, cin, k, w_q.device)
    return torch.take(flat, index).reshape(
        -(-cout // INT8_BLOCK_N) * INT8_BLOCK_N // 8, -1, 32, 8)


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """Kernel D's wgmma kernel at one shape (:func:`w8a8_plan`). A
    warpgroup's tile is ``warp_rows`` x 4 ``warp_cols`` pool windows,
    ``tiles_y`` x ``tiles_x`` tiles an image; a block keeps the weights of
    ``channels`` output channels resident, ``atoms`` rows of 128 bytes each
    (K = (di, dj, ci) laid end to end and padded to whole atoms); a stage
    holds ``ck`` input channels of a tile's window in ``stage_bytes``;
    ``blocks`` blocks a slice of channels walk the tiles (the persistent
    grid; fewer where the batch has fewer tiles); ``shared`` is the dynamic
    shared memory a block asks for. The C entry takes :meth:`c_args` as
    they are and checks only that the kernel's accesses stay within the
    tensors and the shared memory."""
    warp_rows: int
    warp_cols: int
    ck: int
    atoms: int
    stage_bytes: int
    shared: int
    tiles_y: int
    tiles_x: int
    blocks: int
    kernel = "wgmma"
    channels = W8A8_CHANNELS

    def c_args(self) -> Tuple[int, ...]:
        return (1, self.warp_rows, self.warp_cols, self.channels, self.ck,
                self.tiles_y, self.tiles_x, self.atoms, self.stage_bytes, 0,
                self.blocks, self.shared)


@dataclasses.dataclass(frozen=True)
class MmaSyncPlan:
    """Kernel D's mma.sync kernel at one shape (:func:`w8a8_plan`): a
    block makes one pooled row for 128 channels from its stride + k input
    rows, staged ``pixel_bytes`` a pixel in ``shared`` bytes."""
    pixel_bytes: int
    shared: int
    kernel = "mma_sync"

    def c_args(self) -> Tuple[int, ...]:
        return (0,) * 9 + (self.pixel_bytes, 0, self.shared)


W8A8Plan = Union[WgmmaPlan, MmaSyncPlan]


def _pixel_words(cin_words: int, stride: int) -> int:
    """The mma.sync kernel's staged pixel stride in 4-byte words: the
    least (from ``cin_words``) under which the eight rows of a fragment
    load (pixels 2 s g apart) and its four lanes of a row fall in distinct
    banks; ``cin_words`` where none does."""
    for pw in range(cin_words, cin_words + 32):
        banks = {(2 * stride * pw * g + t) % 32 for g in range(8)
                 for t in range(4)}
        if len(banks) == 32:
            return pw
    return cin_words


@functools.lru_cache(maxsize=None)
def w8a8_plan(h: int, w: int, cin: int, cout: int, k: int, stride: int,
              sms: int) -> Optional[W8A8Plan]:
    """Which of kernel D's two kernels takes a shape, and its tiling; None
    where neither does. The wgmma kernel takes stride 1, k = 3, Cin a
    multiple of its 32-deep K step and Cout of 4 (its 4-byte stores),
    where the weights of a slice of 128 output channels (Cout padded to
    whole slices) fit a block beside two warpgroups' two input stages of
    the widest of 128, 64 or 32 channels dividing Cin. Its tile masks the
    fewest windows of 4 x 4, 2 x 8 or 1 x 16 (ties to the squarer tile, as
    ``conv_fused.fused_plan``), and the card's ``sms`` SMs are shared out
    among the slices. Every other shape takes the mma.sync kernel where
    its staged rows fit. Nothing here depends on the batch, and the s32
    sums are exact, so neither does a pooled pixel's code."""
    if cin < 4 or cin % 4 or cout < 1 or k < 1 or stride < 1 or h < k \
            or w < k:
        return None
    if stride == 1 and k == W8A8_K and cin % INT8_K_STEP == 0 \
            and cout % 4 == 0:
        hp, wp = (h - k + 1) // 2, (w - k + 1) // 2
        best = None
        for rows, cols in _ARRANGEMENTS:
            tiles_y, tiles_x = -(-hp // rows), -(-wp // (4 * cols))
            if best is None or tiles_y * tiles_x < best[2] * best[3]:
                best = (rows, cols, tiles_y, tiles_x)
        rows, cols, tiles_y, tiles_x = best
        atoms = -(-k * k * cin // ATOM_BYTES)
        for ck in (c for c in W8A8_STAGES if cin % c == 0):
            # The window of 2 rows + 2 by 8 cols + 2 conv positions, ck +
            # W8A8_PAD bytes a pixel; the resident weights, two stages a
            # warpgroup, the slice's multipliers and biases, and 1024
            # bytes to align the weights.
            stage = (2 * rows + k - 1) * (8 * cols + k - 1) * (ck + W8A8_PAD)
            shared = (atoms * W8A8_CHANNELS * ATOM_BYTES
                      + 2 * W8A8_WARPGROUPS * stage + 2 * W8A8_CHANNELS * 4
                      + 1024)
            if shared <= SMEM_PER_BLOCK:
                slices = -(-cout // W8A8_CHANNELS)
                return WgmmaPlan(rows, cols, ck, atoms, stage, shared,
                                 tiles_y, tiles_x, max(1, sms // slices))
    cin_words = -(-cin // INT8_K_STEP) * INT8_K_STEP // 4
    pixel_bytes = 4 * _pixel_words(cin_words, stride)
    shared = (stride + k) * w * pixel_bytes
    if shared > SMEM_PER_BLOCK:
        return None
    return MmaSyncPlan(pixel_bytes, shared)


@functools.lru_cache(maxsize=None)
def _wgmma_pack_index(cout: int, cin: int, k: int, cout_pad: int,
                      atoms: int, device: torch.device) -> torch.Tensor:
    """For each byte of the wgmma kernel's packed weight, its offset in
    ``[Cout, Cin, k, k]`` with one zero appended, which the padding takes
    (built once a shape and device)."""
    kdim = atoms * ATOM_BYTES
    dest = swizzle_index(cout_pad, kdim, device, 1)  # offsets n K + kk
    n, kk = dest // kdim, dest % kdim
    tap, ci = kk // cin, kk % cin
    offset = ((n * cin + ci) * k + tap // k) * k + tap % k
    valid = (n < cout) & (kk < k * k * cin)
    return torch.where(valid, offset, cout * cin * k * k)


def pack_int8_weight_wgmma(w_q: torch.Tensor, plan: WgmmaPlan
                           ) -> torch.Tensor:
    """int8 ``w_q [Cout, Cin, k, k]`` -> the wgmma kernel's B operand
    ``[atoms, Cout_pad, 128]``: the ``[Cout, K]`` matrix, K ordered (di,
    dj, ci) end to end and padded with zeros to whole 128-byte atoms, Cout
    padded to the plan's slice, K-major and swizzled
    (``ops/wgmma_layout.py``), so that a slice's rows of one atom are one
    run of memory. One gather."""
    cout, cin, k, _ = w_q.shape
    cout_pad = -(-cout // plan.channels) * plan.channels
    flat = F.pad(w_q.reshape(-1), (0, 1))
    index = _wgmma_pack_index(cout, cin, k, cout_pad, plan.atoms,
                              w_q.device)
    return torch.take(flat, index).reshape(plan.atoms, cout_pad, ATOM_BYTES)


def _epilogue_scales(w: torch.Tensor, s_in: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(w_q, mult)``: the quantized weight and ``w_scale * (s_in /
    127)`` in f32, as ``conv_relu_pool_w8a8`` computes them."""
    w_q, w_scale = quantize_weights_per_channel(w)
    return w_q, w_scale * f32(s_in / 127.0)


def _integer_conv(x_q: torch.Tensor, w_q: torch.Tensor, stride: int
                  ) -> torch.Tensor:
    """The VALID conv of int8 codes as float64 ``[B, Hc, Wc, Cout]``, one
    product a filter tap: every product and partial sum is an integer
    below 2^53, so each is exact whatever the order (a library conv might
    take a transform, such as Winograd's, that is not)."""
    batch, h, w, _ = x_q.shape
    cout, _, k, _ = w_q.shape
    hc, wc = (h - k) // stride + 1, (w - k) // stride + 1
    x64, w64 = x_q.double(), w_q.double()
    acc = None
    for di in range(k):
        for dj in range(k):
            tap = x64[:, di:di + stride * (hc - 1) + 1:stride,
                      dj:dj + stride * (wc - 1) + 1:stride]
            term = torch.matmul(tap, w64[:, :, di, dj].t())
            acc = term if acc is None else acc.add_(term)
    return acc


def conv_relu_pool_w8a8_reference(x_q: torch.Tensor, s_in: float,
                                  w: torch.Tensor, b: torch.Tensor,
                                  stride: int, s_out: float) -> torch.Tensor:
    """Plain version of kernel D: the integer conv of ``x_q [B, H, W, Cin]``
    int8 with the quantized ``w [Cout, Cin, k, k]`` in float64 (exact),
    rounded to f32, ``* mult + b`` with one rounding (:func:`fma_f32`),
    then ReLU, the int8 codes and the pool. Returns int8 ``[B, Hp, Wp,
    Cout]``."""
    w_q, mult = _epilogue_scales(w, s_in)
    acc = _integer_conv(x_q, w_q, stride).float()
    return quantize_pool(fma_f32(acc, mult, b.detach().float()), s_out)


def conv_relu_pool_w8a8_cuda(x_q: torch.Tensor, s_in: float, w: torch.Tensor,
                             b: torch.Tensor, stride: int,
                             s_out: float) -> torch.Tensor:
    """Kernel D on ``x_q``'s CUDA device, the kernel that
    :func:`w8a8_plan` names; raises on any input neither takes (Cin a
    multiple of 4, the staged rows within shared memory). The weights are
    quantized and packed for that kernel on every call."""
    if x_q.dim() != 4 or x_q.dtype != torch.int8 or not x_q.is_cuda:
        raise ValueError(f"x_q must be a CUDA int8 [B, H, W, Cin] tensor; "
                         f"got {x_q.dtype} {tuple(x_q.shape)} on "
                         f"{x_q.device}")
    cout, cin, k, k2 = w.shape
    if k != k2 or x_q.shape[-1] != cin or b.shape != (cout,):
        raise ValueError(f"x_q {tuple(x_q.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)} do not match")
    if cin % 4:
        raise ValueError(f"kernel D takes Cin a multiple of 4; got {cin}")
    if w.device != x_q.device or b.device != x_q.device:
        raise ValueError("x_q, w and b must be on one device")
    batch, h, width, _ = x_q.shape
    plan = w8a8_plan(h, width, cin, cout, k, stride,
                     _native.sm_count(x_q.device.index))
    if plan is None:
        raise ValueError(f"no kernel D takes x_q {tuple(x_q.shape)}, k={k}, "
                         f"stride={stride} (w8a8_plan: the staged rows "
                         "exceed a block's shared memory, or the input is "
                         "smaller than the filter)")
    x_q = x_q.contiguous()
    w_q, mult = _epilogue_scales(w, s_in)
    packed = (pack_int8_weight_wgmma(w_q, plan) if plan.kernel == "wgmma"
              else pack_int8_weight(w_q))
    bias = b.detach().float().contiguous()
    hp = ((h - k) // stride + 1) // 2
    wp = ((width - k) // stride + 1) // 2
    out = torch.empty(batch, hp, wp, cout, dtype=torch.int8,
                      device=x_q.device)
    code = _native.library().vqa_conv_relu_pool_int8(
        x_q.data_ptr(), packed.data_ptr(), mult.contiguous().data_ptr(),
        bias.data_ptr(), out.data_ptr(), batch, h, width, cin, cout, k,
        stride, f32(127.0 / s_out), *plan.c_args(),
        _native.stream_ptr(x_q.device))
    _native.check("conv_relu_pool_int8", code)
    if out.numel():  # the C entry launches nothing for no output
        conv_relu_pool_w8a8_cuda.launches += 1
        if plan.kernel == "wgmma":
            conv_relu_pool_w8a8_cuda.launches_wgmma += 1
    return out


conv_relu_pool_w8a8_cuda.launches = 0
conv_relu_pool_w8a8_cuda.launches_wgmma = 0  # those of the wgmma kernel


def _w8a8_fake(x_q, s_in, w, b, stride, s_out):
    batch, h, width, _ = x_q.shape
    k = w.shape[-1]
    return x_q.new_empty(batch, ((h - k) // stride + 1) // 2,
                         ((width - k) // stride + 1) // 2, w.shape[0])


_native.define_op(
    "conv_relu_pool_w8a8",
    "(Tensor x_q, float s_in, Tensor w, Tensor b, int stride, float s_out)"
    " -> Tensor",
    conv_relu_pool_w8a8_reference, conv_relu_pool_w8a8_cuda, _w8a8_fake)


def conv_relu_pool_w8a8(x_q: torch.Tensor, s_in: float, w: torch.Tensor,
                        b: torch.Tensor, stride: int, s_out: float,
                        plain: bool = False) -> torch.Tensor:
    """Port of ``conv_relu_pool_w8a8``: one W8A8 block, int8 in and out.
    ``plain=True`` runs the plain version; otherwise
    ``vqa::conv_relu_pool_w8a8`` dispatches: a CPU tensor runs the plain
    version, a CUDA tensor kernel D, which raises where it cannot
    launch."""
    if plain:
        return conv_relu_pool_w8a8_reference(x_q, s_in, w, b, stride, s_out)
    return torch.ops.vqa.conv_relu_pool_w8a8(x_q, s_in, w, b, stride, s_out)


def dequantize(y_q: torch.Tensor, s: float, dtype: torch.dtype
               ) -> torch.Tensor:
    """int8 codes back to ``dtype``: ``y_q * (s / 127)`` in f32."""
    return (y_q.float() * f32(s / 127.0)).to(dtype)


def int8_stem_forward(convs: Sequence[torch.nn.Module], x: torch.Tensor,
                      scales: Sequence[float], stride: int,
                      dtype: torch.dtype, plain: bool = False
                      ) -> torch.Tensor:
    """The whole int8 CNN stem over the blocks ``convs`` (modules with
    ``weight [Cout, Cin, k, k]`` and ``bias``): conv0 in ``dtype`` with
    kernel 2's int8 mode, blocks 1.. on kernel D, the output dequantized to
    ``dtype``. ``scales[i]`` is block i's calibrated post-ReLU amax."""
    if len(scales) != len(convs):
        raise ValueError(
            f"image.quant_scales has {len(scales)} entries; the stem has "
            f"{len(convs)} conv blocks — recalibrate (calibrate_stem_scales)")
    out = conv_nhwc(x.to(dtype), convs[0].weight.detach(), stride)
    y_q = quantize_relu_pool(out, convs[0].bias.detach(), scales[0], plain)
    for block in range(1, len(convs)):
        y_q = conv_relu_pool_w8a8(
            y_q, scales[block - 1], convs[block].weight.detach(),
            convs[block].bias.detach(), stride, scales[block], plain)
    return dequantize(y_q, scales[-1], dtype)


@torch.no_grad()
def calibrate_stem_scales(model, images, dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[float, ...]:
    """Per-block post-ReLU amax of :class:`~dl_vqa_tpu_torch.models.vqa.
    VqaNet` ``model``'s CNN stem over ``images`` (``[B, H, W, 3]``, uint8
    pixels or normalised floats), from the exact block in ``dtype``: the
    conv, ``relu(f32(conv) + b)``, its amax over the whole conv output, then
    a floor max pool rounded to ``dtype`` for the next block. One Python
    float a block, for ``ImageConfig.quant_scales``."""
    from dl_vqa_tpu_torch.models.layers import normalize_images

    device = next(model.parameters()).device
    y = normalize_images(torch.as_tensor(images).to(device), dtype).to(dtype)
    vals = []
    for conv in model.image.convs():
        a = torch.relu(conv_nhwc(y, conv.weight, model.image.stride)
                       .float() + conv.bias.float())
        vals.append(a.amax())
        y = maxpool_2x2(a).to(dtype)
    vals = torch.stack(vals).cpu().numpy()
    if not np.all(np.isfinite(vals)) or np.any(vals <= 0):
        raise ValueError(
            f"calibration produced non-positive/non-finite amaxes {vals}; "
            "check the calibration batch and params")
    return tuple(float(v) for v in vals)


def with_calibrated_scales(cfg, model, images,
                           dtype: torch.dtype = torch.bfloat16):
    """:func:`calibrate_stem_scales` on ``images``, returned as ``cfg`` with
    ``image.store_dtype='int8'`` and ``image.quant_scales`` set."""
    scales = calibrate_stem_scales(model, images, dtype=dtype)
    return dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, store_dtype="int8", quant_scales=scales))
