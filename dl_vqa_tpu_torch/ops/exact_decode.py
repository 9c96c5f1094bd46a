"""The "exact" image decoder's device stages: PIL's pixels without PIL.

After the host has read a file (``csrc/host/jpeg_entropy.cc`` for a JPEG's
quantized coefficients, :mod:`dl_vqa_tpu_torch.data.image_formats` for a
PNG's or BMP's RGB), two kernels finish the reference transform of
``preprocess_pil_image`` (``dl_vqa_tpu/data/images.py:41-71``) up to its
normalization, to PIL's bits:

* kernel E (``csrc/exact_idct.cu``): dequantization and libjpeg's
  ``jpeg_idct_islow`` (``jidctint.c``), level-shifted and clamped as PIL's
  libjpeg-turbo clamps, a component's coefficients to its plane of
  samples, one launch a JPEG;
* ``color_resample`` (``csrc/exact_color_resample.cu``, kernels F and G
  of the first design in one): libjpeg's chroma upsampling
  (``jdsample.c``) and colour conversion (``jdcolor.c``), then PIL's
  ``convert("RGB")``, and Pillow's bilinear ``ImagingResample`` of the
  shorter edge to ``int(S / central_fraction)`` at the centre crop's
  pixels only, for a whole batch of images in one launch, a block an
  output tile of an image (:func:`tile_plan`).

None replaces a TPU kernel: the JAX package runs PIL on the host. Each
has its plain version here (:func:`idct_islow_reference`, and
:func:`color_resample_reference`: :func:`upsample_color_reference` then
:func:`pil_resample_reference`): integer tensor code vectorized over
blocks, rows and pixels, which is the CPU path and the kernel's oracle to
the bit. A decode (:func:`decode_batch` a chunk of images,
:func:`decode_on_device` one) takes the plain versions on the CPU, and on
a card runs the chunk's kernels in one call (:func:`exact_decode_cuda`,
``csrc/exact_pipeline.cu``), which counts the kernels it launches;
nothing falls back. ``exact_idct_cuda`` and ``color_resample_cuda``
launch one kernel each (each counting its own launches), for checking a
kernel alone against its plain version.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["GREY", "RGB", "YCBCR", "CMYK", "YCCK", "Component",
           "upsample_method", "idct_islow_reference", "exact_idct_cuda",
           "upsample_color_reference", "ResamplePlan", "resample_plan",
           "pil_resample_reference", "Planes", "TilePlan", "tile_plan",
           "plan_of", "color_resample_reference", "ColorResampleBatch",
           "color_resample_batch", "color_resample_cuda", "StagingPool",
           "exact_decode_cuda", "decode_batch", "decode_on_device"]

# libjpeg's J_COLOR_SPACE values (csrc/host/jpeg_entropy.h).
GREY, RGB, YCBCR, CMYK, YCCK = 1, 2, 3, 4, 5

# Upsampling methods (csrc/exact_color_resample.cu Method).
FULL, H2V1, H1V2, H2V2, REPLICATE = 0, 1, 2, 3, 4

# jidctint.c at CONST_BITS 13.
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _range_limit(x: torch.Tensor) -> torch.Tensor:
    """The last stage of the inverse DCT: the level shift and a clamp to
    0-255. libjpeg's C code indexes ``range_limit[x & 1023]``
    (``jdmaster.c`` prepare_range_limit_table), which wraps values beyond
    +-384; PIL's libjpeg-turbo runs its SIMD inverse DCT instead, whose
    saturating packs clamp, and PIL's pixels follow the clamp there
    (``tests/test_torch_exact_decode.py``). The two agree within +-384."""
    return (x + 128).clamp(0, 255).to(torch.uint8)


@dataclass(frozen=True)
class Component:
    """One JPEG component as kernel F reads it: its sampling factors, its
    real samples (libjpeg's ``downsampled_width``, ``_height``) and the
    frame's largest factors."""
    h: int
    v: int
    width: int
    height: int
    max_h: int
    max_v: int


def upsample_method(c: Component) -> int:
    """``jdsample.c`` jinit_upsampler's choice at do_fancy_upsampling: the
    fancy h2v1 and h2v2 filters over 2 samples wide, h1v2 fancy at any
    width, full size, else replication (an integral ratio)."""
    he, ve = c.max_h // c.h, c.max_v // c.v
    if (he, ve) == (1, 1):
        return FULL
    if (he, ve) == (2, 1):
        return H2V1 if c.width > 2 else REPLICATE
    if (he, ve) == (1, 2):
        return H1V2
    if (he, ve) == (2, 2):
        return H2V2 if c.width > 2 else REPLICATE
    return REPLICATE


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``jidctint.c``'s one-dimensional pass on int64 inputs ``s[0..7]``:
    the eight outputs before their descale."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 + z3 * -_F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (s[0] + s[4]) * (1 << _CONST_BITS)
    tmp1 = (s[0] - s[4]) * (1 << _CONST_BITS)
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow_reference(coef: torch.Tensor, qtable: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of kernel E: int16 ``[blocks_h, blocks_w, 64]``
    coefficients (natural order) and their ``[64]`` quantization table
    (int16 holding libjpeg's uint16 values) ->
    uint8 plane ``[blocks_h * 8, blocks_w * 8]``, libjpeg's
    ``jpeg_idct_islow`` to the bit (its all-zero shortcuts give the same
    values as the full passes), its range limit PIL's clamp
    (:func:`_range_limit`)."""
    bh, bw, _ = coef.shape
    deq = (coef.to(torch.int64) * (qtable.to(torch.int64) & 0xFFFF)
           ).reshape(bh * bw, 8, 8)
    cols = _idct_1d([deq[:, k, :] for k in range(8)])
    # The column pass's results are kept as int (32 bits).
    ws = torch.stack([_descale(o, _CONST_BITS - _PASS1_BITS)
                      for o in cols], dim=1).to(torch.int32).to(torch.int64)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])
    x = torch.stack([_descale(o, _CONST_BITS + _PASS1_BITS + 3)
                     for o in rows], dim=2)
    out = _range_limit(x)
    return out.reshape(bh, bw, 8, 8).permute(0, 2, 1, 3).reshape(
        bh * 8, bw * 8)


def _check_planes(coefs, qtables) -> torch.device:
    if not 1 <= len(coefs) == len(qtables) <= 4:
        raise ValueError(f"1 to 4 components, a table each; got "
                         f"{len(coefs)} and {len(qtables)}")
    device = coefs[0].device
    for c, q in zip(coefs, qtables):
        if c.dtype != torch.int16 or c.dim() != 3 or c.shape[2] != 64:
            raise ValueError(f"coefficients must be int16 [bh, bw, 64]; got "
                             f"{c.dtype} {tuple(c.shape)}")
        if q.dtype != torch.int16 or q.shape != (64,):
            raise ValueError(f"a quantization table must be int16 [64] "
                             f"(libjpeg's uint16 bits); got {q.dtype} "
                             f"{tuple(q.shape)}")
        if c.device != device or q.device != device:
            raise ValueError("the components and tables must share a device")
    return device


def exact_idct_cuda(coefs: Sequence[torch.Tensor],
                    qtables: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Kernel E on every component of an image in one launch; raises on
    any input it does not take. Tables are int16 holding libjpeg's uint16
    values."""
    device = _check_planes(coefs, qtables)
    if device.type != "cuda":
        raise ValueError(f"kernel E takes CUDA tensors; got {device}")
    coefs = [c.contiguous() for c in coefs]
    tables = [q.contiguous() for q in qtables]
    outs = [torch.empty(c.shape[0] * 8, c.shape[1] * 8, dtype=torch.uint8,
                        device=device) for c in coefs]
    pad = 4 - len(coefs)
    lib = _native.library()
    code = lib.vqa_exact_idct(
        *[c.data_ptr() for c in coefs], *[None] * pad,
        *[q.data_ptr() for q in tables], *[None] * pad,
        *[o.data_ptr() for o in outs], *[None] * pad,
        *[c.shape[1] for c in coefs], *[0] * pad,
        *[c.shape[0] for c in coefs], *[0] * pad,
        len(coefs), _native.stream_ptr(device))
    _native.check("exact_idct", code)
    exact_idct_cuda.launches += 1
    return outs


exact_idct_cuda.launches = 0


def _upsample(plane: torch.Tensor, c: Component, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """One component's samples at output columns ``x`` and rows ``y``
    (int64 vectors), int64 ``[len(y), len(x)]``, read from its real
    samples only (the plane's padding never: indices are clamped to its
    real width and height, which also gives the replicated edges)."""
    p = plane[:c.height, :c.width].to(torch.int64)
    he, ve = c.max_h // c.h, c.max_v // c.v

    def at(rows, cols):
        return p[rows.clamp(0, c.height - 1)[:, None],
                 cols.clamp(0, c.width - 1)[None, :]]

    method = upsample_method(c)
    if method == FULL:
        return at(y, x)
    if method == REPLICATE:
        return at(y // ve, x // he)
    odd_x, odd_y = (x & 1)[None, :], (y & 1)[:, None]
    if method == H2V1:
        j = x >> 1
        near = 3 * at(y, j)
        return torch.where(odd_x == 1, (near + at(y, j + 1) + 2) >> 2,
                           (near + at(y, j - 1) + 1) >> 2)
    r = y >> 1
    far = torch.where((y & 1) == 1, r + 1, r - 1)
    if method == H1V2:
        return (3 * at(r, x) + at(far, x) + 1 + odd_y) >> 2
    j = x >> 1
    k = torch.where((x & 1) == 1, j + 1, j - 1)
    here = 3 * at(r, j) + at(far, j)
    there = 3 * at(r, k) + at(far, k)
    return (3 * here + there + 8 - odd_x) >> 4


def _ycc(y, cb, cr):
    """``jdcolor.c`` ycc_rgb_convert before its clamp: int64 R, G, B."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    xb, xr = cb - 128, cr - 128
    half = 1 << 15
    return (y + ((fix(1.40200) * xr + half) >> 16),
            y + ((-fix(0.34414) * xb + half - fix(0.71414) * xr) >> 16),
            y + ((fix(1.77200) * xb + half) >> 16))


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def upsample_color_reference(planes: Sequence[torch.Tensor],
                             components: Sequence[Component],
                             color_space: int, width: int, height: int
                             ) -> torch.Tensor:
    """Plain version of ``color_resample``'s first half (kernel F of the
    first design): the planes of kernel E and their components -> uint8
    ``[height, width, 3]``, libjpeg's upsampling and colour conversion and
    PIL's ``convert("RGB")`` to the bit."""
    dev = planes[0].device
    return _color(planes, components, color_space,
                  torch.arange(width, device=dev),
                  torch.arange(height, device=dev))


def _color(planes, components, color_space: int, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    """:func:`upsample_color_reference` at output columns ``x`` and rows
    ``y`` only -> uint8 ``[len(y), len(x), 3]``."""
    s = [_upsample(p, c, x, y) for p, c in zip(planes, components)]
    if color_space == GREY:
        rgb = [s[0]] * 3
    elif color_space == RGB:
        rgb = s[:3]
    elif color_space == YCBCR:
        rgb = [v.clamp(0, 255) for v in _ycc(*s[:3])]
    elif color_space in (CMYK, YCCK):
        cmyk = s[:4]
        if color_space == YCCK:
            cmyk = [(255 - v).clamp(0, 255) for v in _ycc(*s[:3])] + [s[3]]
        nk = cmyk[3]  # 255 - the inverted K of "CMYK;I"
        rgb = [nk - _muldiv255(255 - v, nk) for v in cmyk[:3]]
    else:
        raise ValueError(f"unknown colour space {color_space}")
    return torch.stack(rgb, dim=-1).to(torch.uint8)


def _check_color(planes, components, color_space, width, height):
    if not 1 <= len(planes) == len(components) <= 4:
        raise ValueError(f"1 to 4 planes, a component each; got "
                         f"{len(planes)} and {len(components)}")
    need = {GREY: 1, RGB: 3, YCBCR: 3, CMYK: 4, YCCK: 4}.get(color_space)
    if need != len(planes):
        raise ValueError(f"colour space {color_space} with {len(planes)} "
                         "planes")
    device = planes[0].device
    for p, c in zip(planes, components):
        if p.dtype != torch.uint8 or p.dim() != 2 or p.device != device:
            raise ValueError("planes must be uint8 [rows, pitch] on one "
                             "device")
        if (p.shape[0] < c.height or p.shape[1] < c.width
                or c.max_h % c.h or c.max_v % c.v):
            raise ValueError(f"a plane {tuple(p.shape)} short of its "
                             f"component {c}")
    if not (1 <= width <= 65535 and 1 <= height <= 65535):
        raise ValueError(f"an image of {width}x{height}")
    return device


_PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 - 2


@dataclass(frozen=True, eq=False)
class ResamplePlan:
    """Pillow's bilinear taps for the centre crop of one resize: int32
    ``taps`` holding ``[size, 2 + kx]`` for the crop's columns (first
    input column, count, ``kx`` coefficients) then ``[size, 2 + ky]`` for
    its rows, at 22 fraction bits. Hashed by identity (:func:`tile_plan`
    caches by it; :func:`resample_plan` gives one object a geometry)."""
    in_w: int
    in_h: int
    size: int
    kx: int
    ky: int
    taps: np.ndarray


def _coefficients(in_size: int, out_size: int, first: int, count: int
                  ) -> np.ndarray:
    """``Resample.c`` precompute_coeffs (bilinear, support 1) and
    normalize_coeffs_8bpc for outputs ``first .. first + count - 1``, in
    double in Pillow's order of operations -> int32 ``[count, 2 +
    ksize]``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xx = np.arange(first, first + count, dtype=np.float64)
    center = (xx + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    n = xmax - xmin
    k = np.zeros((count, ksize), dtype=np.float64)
    ww = np.zeros(count, dtype=np.float64)
    for t in range(ksize):
        x = np.abs(((xmin + t).astype(np.float64) - center + 0.5) * ss)
        w = np.where(x < 1.0, 1.0 - x, 0.0)
        w = np.where(t < n, w, 0.0)
        k[:, t] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    scaled = k * (1 << _PRECISION_BITS)
    fixed = np.where(scaled < 0, scaled - 0.5, scaled + 0.5).astype(np.int64)
    out = np.empty((count, 2 + ksize), dtype=np.int32)
    out[:, 0], out[:, 1], out[:, 2:] = xmin, n, fixed
    return out


@functools.lru_cache(maxsize=256)
def resample_plan(width: int, height: int, image_size: int,
                  central_fraction: float) -> ResamplePlan:
    """The taps of ``preprocess_pil_image``'s resize and crop of a
    ``width`` x ``height`` image (cached by its arguments; the plan is
    read-only): the shorter edge to ``int(image_size /
    central_fraction)``, the other to ``int(target * long / short)``
    (Python's double arithmetic), the crop at ``int(round((w - size) /
    2))`` (a half to the even integer). A side already at its target gets
    the identity taps, as Pillow skips that pass."""
    if width < 1 or height < 1:
        raise ValueError(f"an image of {width}x{height}")
    target = int(image_size / central_fraction)
    if width <= height:
        new_w, new_h = target, int(target * height / width)
    else:
        new_w, new_h = int(target * width / height), target
    if new_w < image_size or new_h < image_size:
        raise ValueError(f"image_size {image_size} and central_fraction "
                         f"{central_fraction}: the resize to {new_w}x"
                         f"{new_h} is smaller than the crop")
    left = int(round((new_w - image_size) / 2.0))
    top = int(round((new_h - image_size) / 2.0))
    xs = _coefficients(width, new_w, left, image_size)
    ys = _coefficients(height, new_h, top, image_size)
    taps = np.concatenate([xs.ravel(), ys.ravel()])
    taps.flags.writeable = False  # cached: every caller shares it
    return ResamplePlan(width, height, image_size, xs.shape[1] - 2,
                        ys.shape[1] - 2, taps)


def _pass(values: torch.Tensor, first: torch.Tensor, count: torch.Tensor,
          k: torch.Tensor, axis_len: int) -> torch.Tensor:
    """One of Pillow's passes along dim 0 of int64 ``values [L, ...]``:
    output i sums ``values[first[i] + t] * k[i, t]`` over ``t < count[i]``
    from ``1 << 21``, then ``>> 22`` clipped to 0-255."""
    shape = (-1,) + (1,) * (values.dim() - 1)
    acc = torch.full((first.shape[0],) + values.shape[1:],
                     1 << (_PRECISION_BITS - 1), dtype=torch.int64,
                     device=values.device)
    for t in range(k.shape[1]):
        w = torch.where(t < count, k[:, t], 0)
        acc += values[(first + t).clamp(max=axis_len - 1)] * w.reshape(shape)
    return (acc >> _PRECISION_BITS).clamp(0, 255)


def pil_resample_reference(rgb: torch.Tensor, plan: ResamplePlan
                           ) -> torch.Tensor:
    """Plain version of kernel G: uint8 ``[in_h, in_w, 3]`` -> uint8
    ``[size, size, 3]``, Pillow's two passes (columns, then rows) at the
    crop's pixels, to the bit."""
    taps = torch.tensor(plan.taps, dtype=torch.int64, device=rgb.device)
    xs = taps[:plan.size * (2 + plan.kx)].reshape(plan.size, 2 + plan.kx)
    ys = taps[plan.size * (2 + plan.kx):].reshape(plan.size, 2 + plan.ky)
    lo = int(ys[:, 0].min())
    hi = int((ys[:, 0] + ys[:, 1]).max())
    rows = rgb[lo:max(hi, lo + 1)].to(torch.int64)  # the rows the taps read
    across = _pass(rows.transpose(0, 1), xs[:, 0], xs[:, 1], xs[:, 2:],
                   plan.in_w).transpose(0, 1)        # [rows, size, 3]
    out = _pass(across, ys[:, 0] - lo, ys[:, 1], ys[:, 2:], across.shape[0])
    return out.to(torch.uint8)


# csrc/exact_color_resample.cu: the int64 fields of an image's descriptor
# (ImageField) and the int32 fields of a tile's plan (TileField), and a
# block's dynamic shared memory at most (kMaxDynamic: an H100's 232,448
# bytes less a KiB for the kernel's static shared memory).
IMAGE_FIELDS, TILE_FIELDS = 38, 36
SMEM_LIMIT = 232448 - 1024
# The plan's aim: at most 48 KB a block, so that four blocks (32 warps)
# share an SM. COCO's 640x480 to 224 takes 32-pixel tiles of 43 KB.
SMEM_TARGET = 48 << 10
TILE_SIDES = (32, 16, 8, 4, 2, 1)
(_T_IMAGE, _T_OX, _T_OY, _T_TW, _T_TH, _T_X0, _T_Y0, _T_RW, _T_RH,
 _T_STRIP, _T_WIN) = range(11)
_T_PLANE = _T_WIN + 3 * 4
_T_UP = _T_PLANE + 4
_T_RGB, _T_H, _T_XT, _T_YT, _T_OUT, _T_END = range(_T_UP + 4, TILE_FIELDS)


class Planes(NamedTuple):
    """A JPEG's planes as ``color_resample`` takes them: kernel E's uint8
    ``[blocks_h * 8, blocks_w * 8]`` planes, their components, the colour
    space and the image's size (:func:`upsample_color_reference`'s
    arguments)."""
    planes: Sequence[torch.Tensor]
    components: Sequence[Component]
    color_space: int
    width: int
    height: int


@dataclass(frozen=True, eq=False)
class TilePlan:
    """``color_resample``'s tiles of one image (:func:`tile_plan`): int32
    ``tiles [n, TILE_FIELDS]`` (image index 0), row-major over the crop,
    each with its output pixels, the input rectangle its taps reach, the
    rows of that rectangle coloured at a time (a strip), each component's
    window of samples (first column, width, rows at most) and its
    shared-memory offsets (each component's window and upsampled strip,
    the strip's RGB, the horizontal pass, the taps, the output tile:
    ``csrc/exact_color_resample.cu`` TileField);
    ``side``: the tiles' side in output pixels; ``smem``: the largest
    tile's shared bytes."""
    side: int
    tiles: np.ndarray
    smem: int


def _window(first, last, expand, real):
    """The samples of a component (``real`` of them along an axis, each
    output pixel ``expand`` times its index) that output pixels ``first
    .. last`` read: ``pixel // expand`` with one of halo each side (the
    fancy filters' nearer and farther samples), clamped to the real
    samples; ``(lo, hi)`` inclusive. The kernel stages a strip's rows by
    the same bound."""
    return (np.maximum(first // expand - 1, 0),
            np.minimum(last // expand + 1, real - 1))


def _round16(n):
    return (n + 15) & ~15


def _tiles(xt, yt, kx: int, ky: int, size: int, components, side: int,
           strip: int = 0) -> np.ndarray:
    """int64 ``[n, TILE_FIELDS]``: the crop cut into tiles of ``side``
    output pixels, each rectangle coloured ``strip`` rows at a time (0:
    the whole rectangle at once)."""
    starts = np.arange(0, size, side)
    extent = np.minimum(side, size - starts)
    x_first = np.minimum.reduceat(xt[:, 0], starts)
    x_end = np.maximum.reduceat(xt[:, 0] + xt[:, 1], starts)
    y_first = np.minimum.reduceat(yt[:, 0], starts)
    y_end = np.maximum.reduceat(yt[:, 0] + yt[:, 1], starts)
    row, col = (a.ravel() for a in np.meshgrid(
        np.arange(starts.size), np.arange(starts.size), indexing="ij"))
    t = np.zeros((row.size, TILE_FIELDS), dtype=np.int64)
    t[:, _T_OX], t[:, _T_OY] = starts[col], starts[row]
    tw, th = extent[col], extent[row]
    t[:, _T_TW], t[:, _T_TH] = tw, th
    x0, y0 = x_first[col], y_first[row]
    rw, rh = (x_end - x_first)[col], (y_end - y_first)[row]
    t[:, _T_X0], t[:, _T_Y0], t[:, _T_RW], t[:, _T_RH] = x0, y0, rw, rh
    sh = np.minimum(strip, rh) if strip else rh
    t[:, _T_STRIP] = sh
    at = np.zeros(row.size, dtype=np.int64)
    for k, c in enumerate(components or ()):
        he, ve = c.max_h // c.h, c.max_v // c.v
        lo, hi = _window(x0, x0 + rw - 1, he, c.width)
        # 16-byte copies where the pitch allows (else 8): inside the plane's
        # pitch, a multiple of 8 of at least the real width.
        c0 = lo & ~15
        ww = np.minimum((hi + 1 - c0 + 15) & ~15,
                        ((c.width + 7) & ~7) - c0)
        # A strip of sh rows reads at most this many plane rows.
        rows = np.minimum((sh + ve - 2) // ve + 3, c.height)
        t[:, _T_WIN + 3 * k], t[:, _T_WIN + 3 * k + 1] = c0, ww
        t[:, _T_WIN + 3 * k + 2] = rows
        t[:, _T_PLANE + k] = at
        at = at + _round16(rows * ww)
    for k, c in enumerate(components or ()):
        # A subsampled component's strip upsampled (a full-size one is read
        # from its window).
        t[:, _T_UP + k] = at
        if upsample_method(c) != FULL:
            at = at + _round16(sh * rw)
    # RGB and the horizontal pass a pixel in 32 bits (R in the low byte).
    for field, nbytes in ((_T_RGB, sh * rw * 4), (_T_H, rh * tw * 4),
                          (_T_XT, tw * (2 + kx) * 4),
                          (_T_YT, th * (2 + ky) * 4), (_T_OUT, th * tw * 3)):
        t[:, field] = at
        at = at + _round16(nbytes)
    t[:, _T_END] = at
    return t


@functools.lru_cache(maxsize=256)
def tile_plan(plan: ResamplePlan, components: tuple = None,
              target: int = SMEM_TARGET) -> TilePlan:
    """``color_resample``'s tiles for one image: the resize ``plan`` of a
    JPEG of ``components`` (a tuple of :class:`Component`), or of an RGB8
    image (``None``); cached (read-only). The tiles' side is the largest of
    ``TILE_SIDES`` whose every tile needs at most ``target`` shared bytes;
    where even one-pixel tiles need more (an image far larger than the
    crop), each rectangle is coloured in strips of the most rows that keep
    within it. Raises where a tile would need more than a block can hold
    (``SMEM_LIMIT``)."""
    size, kx, ky = plan.size, plan.kx, plan.ky
    xt = plan.taps[:size * (2 + kx)].reshape(size, 2 + kx).astype(np.int64)
    yt = plan.taps[size * (2 + kx):].reshape(size, 2 + ky).astype(np.int64)

    def need(t):
        return int(t[:, _T_END].max())

    for side in TILE_SIDES:
        tiles = _tiles(xt, yt, kx, ky, size, components, side)
        if need(tiles) <= target:
            break
    else:
        lo, hi = 1, int(tiles[:, _T_RH].max())
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if need(_tiles(xt, yt, kx, ky, size, components, 1, mid)
                    ) <= target:
                lo = mid
            else:
                hi = mid - 1
        tiles = _tiles(xt, yt, kx, ky, size, components, 1, lo)
    if need(tiles) > SMEM_LIMIT:
        raise ValueError(f"a resize of {plan.in_w}x{plan.in_h} to {size}: "
                         f"a tile needs {need(tiles)} bytes of shared "
                         f"memory, over a block's {SMEM_LIMIT}")
    out = tiles.astype(np.int32)
    out.flags.writeable = False  # cached: every caller shares it
    return TilePlan(side, out, need(tiles))


def _layout_of(source):
    """A decode source's components (a JPEG's, as a tuple) or ``None``
    (RGB8)."""
    return tuple(source.components) if hasattr(source, "export") else None


def _size_of(source) -> tuple:
    if hasattr(source, "export"):
        return source.width, source.height
    return source.shape[1], source.shape[0]


def plan_of(source, image_size: int, central_fraction: float
            ) -> ResamplePlan:
    """The resize plan of a decode's source (an ``image_formats.JpegData``
    or RGB8 ``[h, w, 3]``), its tiles planned (:func:`tile_plan`, cached),
    so that an image they cannot take raises here."""
    width, height = _size_of(source)
    plan = resample_plan(width, height, image_size, central_fraction)
    tile_plan(plan, _layout_of(source))
    return plan


def color_resample_reference(images: Sequence, plans: Sequence[ResamplePlan]
                             ) -> torch.Tensor:
    """Plain version of ``color_resample``: each image (a :class:`Planes`,
    or an RGB8 ``[h, w, 3]`` tensor) through
    :func:`upsample_color_reference` (a JPEG's), then
    :func:`pil_resample_reference` at its plan -> uint8 ``[N, S, S, 3]``."""
    return torch.stack([
        pil_resample_reference(
            upsample_color_reference(*image) if isinstance(image, Planes)
            else image, plan)
        for image, plan in zip(images, plans)])


def _image_row(out: int, taps: int, plan: ResamplePlan, width: int,
               height: int, rgb: int = 0, space: int = 0, planes=()
               ) -> np.ndarray:
    """An image's int64 descriptor (``csrc/exact_color_resample.cu``
    ImageField); ``planes``: ``(address, pitch, Component)`` each."""
    row = np.zeros(IMAGE_FIELDS, dtype=np.int64)
    row[:10] = (out, taps, rgb, plan.kx, plan.ky, plan.size, len(planes),
                space, width, height)
    for k, (address, pitch, c) in enumerate(planes):
        row[10 + 7 * k:17 + 7 * k] = (address, pitch, c.width, c.height,
                                      c.max_h // c.h, c.max_v // c.v,
                                      upsample_method(c))
    return row


def _chunk_tiles(plans: Sequence[TilePlan]) -> tuple:
    """The images' tiles in one int32 array, each with its image's index,
    and the largest tile's shared bytes."""
    tiles = np.concatenate([p.tiles for p in plans])
    tiles[:, _T_IMAGE] = np.repeat(np.arange(len(plans)),
                                   [len(p.tiles) for p in plans])
    return tiles, max(p.smem for p in plans)


@dataclass
class ColorResampleBatch:
    """``color_resample``'s inputs on the card for one launch
    (:func:`color_resample_batch`): the images' descriptors, their tiles,
    the launch's shared bytes and the output ``[N, S, S, 3]``; ``keep``
    holds the tensors the descriptors point at."""
    images: torch.Tensor
    tiles: torch.Tensor
    smem: int
    out: torch.Tensor
    keep: tuple


def color_resample_batch(images: Sequence, plans: Sequence[ResamplePlan]
                         ) -> ColorResampleBatch:
    """``color_resample``'s inputs for a batch (each image a
    :class:`Planes` of kernel E's planes, or an RGB8 ``[h, w, 3]`` tensor,
    all on one card, with its resize plan, all of one size) made ready on
    the card, so that a CUDA graph can capture the launch alone; raises on
    any input the kernel does not take."""
    if not images or len(images) != len(plans):
        raise ValueError(f"{len(images)} images and {len(plans)} plans")
    size = plans[0].size
    if any(p.size != size for p in plans):
        raise ValueError("one crop size a batch")
    first = images[0].planes[0] if isinstance(images[0], Planes) else images[0]
    device = first.device
    if device.type != "cuda":
        raise ValueError(f"color_resample takes CUDA tensors; got {device}")
    out = torch.empty(len(images), size, size, 3, dtype=torch.uint8,
                      device=device)
    taps = {}
    for plan in plans:
        if id(plan) not in taps:
            taps[id(plan)] = torch.from_numpy(plan.taps.copy()).to(device)
    rows, keep, layouts = [], [out, taps], []
    for i, (image, plan) in enumerate(zip(images, plans)):
        at = out[i].data_ptr()
        if isinstance(image, Planes):
            _check_color(*image)
            if (image.width, image.height) != (plan.in_w, plan.in_h):
                raise ValueError(f"an image of {image.width}x{image.height} "
                                 f"with a plan of {plan.in_w}x{plan.in_h}")
            for p in image.planes:
                if (p.device != device or not p.is_contiguous()
                        or p.shape[1] % 8 or p.data_ptr() % 8):
                    raise ValueError("planes must be contiguous, on the "
                                     "batch's card, 8-byte aligned, of a "
                                     "pitch a multiple of 8 (kernel E's)")
            keep.append(image.planes)
            rows.append(_image_row(
                at, taps[id(plan)].data_ptr(), plan, image.width,
                image.height, space=image.color_space, planes=[
                    (p.data_ptr(), p.shape[1], c)
                    for p, c in zip(image.planes, image.components)]))
            layouts.append(tuple(image.components))
        else:
            if (image.dtype != torch.uint8 or image.device != device
                    or tuple(image.shape) != (plan.in_h, plan.in_w, 3)):
                raise ValueError(
                    f"expected uint8 [{plan.in_h}, {plan.in_w}, 3] on "
                    f"{device}; got {image.dtype} {tuple(image.shape)} on "
                    f"{image.device}")
            image = image.contiguous()
            keep.append(image)
            rows.append(_image_row(at, taps[id(plan)].data_ptr(), plan,
                                   plan.in_w, plan.in_h,
                                   rgb=image.data_ptr()))
            layouts.append(None)
    tiles, smem = _chunk_tiles([tile_plan(p, c)
                                for p, c in zip(plans, layouts)])
    return ColorResampleBatch(torch.from_numpy(np.stack(rows)).to(device),
                              torch.from_numpy(tiles).to(device), smem, out,
                              tuple(keep))


def color_resample_cuda(batch: ColorResampleBatch) -> torch.Tensor:
    """``color_resample`` over a batch made ready by
    :func:`color_resample_batch`, one launch on the current stream ->
    its ``out``."""
    code = _native.library().vqa_color_resample(
        batch.images.data_ptr(), batch.tiles.data_ptr(), len(batch.tiles),
        batch.smem, _native.stream_ptr(batch.out.device))
    _native.check("color_resample", code)
    color_resample_cuda.launches += 1
    return batch.out


color_resample_cuda.launches = 0


class _Staging:
    """What one decode in flight holds on a card: its own stream (a decode
    waits for no other work; the model's forwards run on the default
    stream), a pinned host buffer the inputs go through, a device buffer
    for the inputs and every intermediate, and a pinned buffer for the
    output."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.host = self.dev = self.out = None

    def reserve(self, in_bytes: int, dev_bytes: int, out_bytes: int
                ) -> None:
        def grown(n):
            return 1 << max(n - 1, 1).bit_length()

        if self.host is None or self.host.numel() < in_bytes:
            self.host = torch.empty(grown(in_bytes), dtype=torch.uint8,
                                    pin_memory=True)
        if self.dev is None or self.dev.numel() < dev_bytes:
            self.dev = torch.empty(grown(dev_bytes), dtype=torch.uint8,
                                   device=self.device)
        if self.out is None or self.out.numel() < out_bytes:
            self.out = torch.empty(grown(out_bytes), dtype=torch.uint8,
                                   pin_memory=True)

    def trim(self, keep_bytes: int) -> None:
        """Drops each buffer over ``keep_bytes`` (a rare large image's), so
        that between decodes a staging holds at most that much a buffer.
        Its memory goes back to PyTorch's caching allocators, where later
        allocations reuse it."""
        for name in ("host", "dev", "out"):
            buf = getattr(self, name)
            if buf is not None and buf.numel() > keep_bytes:
                setattr(self, name, None)


class StagingPool:
    """At most ``size`` stagings a device, made as decodes need them: a
    decode takes one, waiting while all are in use, and gives it back
    trimmed to ``keep_bytes`` a buffer. So what the pool holds on a card
    and in pinned memory is bounded by ``size`` and, between decodes, by
    ``keep_bytes``, whatever the callers' concurrency and image sizes.
    ``make(device)`` makes a staging."""

    def __init__(self, make, size: int, keep_bytes: int):
        if size < 1:
            raise ValueError(f"a pool of {size} stagings")
        self._make, self.size, self.keep_bytes = make, size, keep_bytes
        self._lock = threading.Lock()
        self._free = {}  # device -> threading.Semaphore of stagings left
        self._idle = {}  # device -> [idle staging]
        self.made = {}   # device -> stagings made

    def take(self, device):
        with self._lock:
            free = self._free.setdefault(device,
                                         threading.Semaphore(self.size))
        free.acquire()
        with self._lock:
            idle = self._idle.setdefault(device, [])
            if idle:
                return idle.pop()
        try:
            st = self._make(device)
        except BaseException:
            free.release()
            raise
        with self._lock:
            self.made[device] = self.made.get(device, 0) + 1
        return st

    def give(self, device, st) -> None:
        st.trim(self.keep_bytes)
        with self._lock:
            self._idle[device].append(st)
        self._free[device].release()


# Eight decodes in flight a card (a chunk of a list of files, or one image of
# the front's; more callers wait for a staging, which a decode holds for its
# device stages only), each staging keeping up to 16 MiB a buffer between
# decodes. One COCO-sized JPEG (640x480 4:2:0) takes 0.92 MB of pinned
# coefficients in, 1.4 MB on the card and 0.15 MB of pinned output; a chunk
# of EXACT_CHUNK = 64 of them (data/images.py) 59 MB, 98 MB and 9.6 MB,
# rounded up to 64, 128 and 16 MiB: dropped when the chunk gives its staging
# back, into PyTorch's caching allocators, which hand them to the next
# chunk.
_POOL = StagingPool(_Staging, size=8, keep_bytes=16 << 20)


def _aligned(n: int) -> int:
    return (n + 255) & ~255


def _layout(sizes) -> tuple:
    """Offsets of consecutive regions of ``sizes`` bytes, each 256-byte
    aligned, and the bytes they span."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += _aligned(n)
    return offsets, total


def exact_decode_cuda(sources: Sequence, plans: Sequence[ResamplePlan],
                      st: "_Staging") -> np.ndarray:
    """A chunk's device stages in one call of ``vqa_exact_decode_batch``
    (``csrc/exact_pipeline.cu``) -> uint8 ``[N, S, S, 3]`` on the host:
    the inputs (each JPEG's coefficients and tables, exported by the
    entropy decoder straight into pinned memory, each PNG's or BMP's RGB8,
    the resizes' taps, the images' descriptors and their tiles) to the card
    in one copy, kernel E for each JPEG and one launch of
    ``color_resample`` over the chunk on ``st``'s stream, the output back
    through pinned memory and waited for, the interpreter lock given up
    once. ``sources[i]`` is an ``image_formats.JpegData`` or RGB8 ``[h, w,
    3]``, ``plans[i]`` its resize plan, all of one size.
    ``exact_decode_cuda.launches`` counts the kernels it launches, by
    name: ``exact_idct`` a JPEG, ``color_resample`` a call."""
    n, size = len(sources), plans[0].size
    if not n or len(plans) != n or any(p.size != size for p in plans):
        raise ValueError(f"{n} sources and {len(plans)} plans of one size")
    jpeg = [hasattr(s, "export") for s in sources]
    for s, is_jpeg in zip(sources, jpeg):
        if is_jpeg and not 1 <= len(s.shapes) <= 4:
            raise ValueError(f"a JPEG of {len(s.shapes)} components")
    tiles, smem = _chunk_tiles([tile_plan(p, _layout_of(s))
                                for s, p in zip(sources, plans)])
    # The input regions: each JPEG's coefficients then its tables, or the
    # RGB8; each plan's taps once; the descriptors; the tiles.
    sizes, planes = [], []
    for s, is_jpeg in zip(sources, jpeg):
        if is_jpeg:
            sizes += [2 * bh * bw * 64 for bh, bw in s.shapes]
            sizes += [128] * len(s.shapes)
            planes += [bh * bw * 64 for bh, bw in s.shapes]
        else:
            sizes.append(s.nbytes)
    taps = {}  # id(plan) -> (its region, the plan)
    for p in plans:
        if id(p) not in taps:
            taps[id(p)] = len(sizes), p
            sizes.append(p.taps.nbytes)
    sizes += [n * IMAGE_FIELDS * 8, tiles.nbytes]
    in_offsets, in_bytes = _layout(sizes)
    out_bytes = n * size * size * 3
    dev_offsets, dev_bytes = _layout([in_bytes] + planes + [out_bytes])
    st.reserve(in_bytes, dev_bytes, out_bytes)
    host, dev = st.host.numpy(), st.dev.data_ptr()
    dev_out = dev + dev_offsets[-1]
    rows = np.zeros((n, IMAGE_FIELDS), dtype=np.int64)
    jpegs = []  # csrc/exact_pipeline.cu: ncomp, then 5 a component
    region, plane = 0, 1
    for i, (s, is_jpeg, p) in enumerate(zip(sources, jpeg, plans)):
        out = dev_out + i * size * size * 3
        tap = dev + in_offsets[taps[id(p)][0]]
        if is_jpeg:
            k = len(s.shapes)
            s.export(st.host.data_ptr(), np.array(
                [at for c in range(k) for at in (in_offsets[region + c],
                                                 in_offsets[region + k + c])],
                dtype=np.int64))
            entry = np.zeros(21, dtype=np.int64)
            entry[0] = k
            for c, ((bh, bw), comp) in enumerate(zip(s.shapes,
                                                     s.components)):
                entry[1 + 5 * c:6 + 5 * c] = (
                    dev + in_offsets[region + c],
                    dev + in_offsets[region + k + c],
                    dev + dev_offsets[plane + c], bw, bh)
            jpegs.append(entry)
            rows[i] = _image_row(out, tap, p, s.width, s.height,
                                 space=s.color_space, planes=[
                                     (dev + dev_offsets[plane + c], bw * 8,
                                      comp) for c, ((_, bw), comp) in
                                     enumerate(zip(s.shapes, s.components))])
            region, plane = region + 2 * k, plane + k
        else:
            at = in_offsets[region]
            host[at:at + s.nbytes] = np.ascontiguousarray(s).reshape(-1)
            rows[i] = _image_row(out, tap, p, s.shape[1], s.shape[0],
                                 rgb=dev + at)
            region += 1
    for at, p in taps.values():
        host[in_offsets[at]:in_offsets[at] + p.taps.nbytes] = p.taps.view(
            np.uint8)
    for array, at in ((rows, in_offsets[-2]), (tiles, in_offsets[-1])):
        host[at:at + array.nbytes] = array.view(np.uint8).reshape(-1)
    desc = np.concatenate([np.array(
        [st.host.data_ptr(), dev, in_bytes, st.out.data_ptr(), dev_out,
         out_bytes, dev + in_offsets[-2], dev + in_offsets[-1], len(tiles),
         smem, len(jpegs)], dtype=np.int64)] + jpegs)
    code = _native.library().vqa_exact_decode_batch(desc.ctypes.data,
                                                    st.stream.cuda_stream)
    _native.check("exact_decode", code)
    counts = exact_decode_cuda.launches
    with _COUNTS_LOCK:  # decodes run on many threads at once
        counts["exact_idct"] += len(jpegs)
        counts["color_resample"] += 1
    return st.out[:out_bytes].numpy().reshape(n, size, size, 3).copy()


exact_decode_cuda.launches = {"exact_idct": 0, "color_resample": 0}
_COUNTS_LOCK = threading.Lock()


def _plain_input(source):
    """A decode source as the plain versions take it: a JPEG's planes
    (kernel E's plain version) or the RGB8 as a tensor."""
    if not hasattr(source, "export"):
        return torch.from_numpy(source)
    planes = [idct_islow_reference(torch.from_numpy(c), torch.from_numpy(q))
              for c, q in zip(source.coefficients, source.qtables)]
    return Planes(planes, source.components, source.color_space,
                  source.width, source.height)


def decode_batch(sources: Sequence, plans: Sequence[ResamplePlan],
                 device: torch.device) -> np.ndarray:
    """The exact decoder's device stages of a chunk -> uint8 ``[N, S, S,
    3]`` on the host: each source a JPEG's coefficients and tables (an
    ``image_formats.JpegData``) or a PNG's or BMP's RGB8 ``[h, w, 3]``,
    with its plan (:func:`plan_of`). On a CUDA ``device`` one call on a
    staging of the pool (:func:`exact_decode_cuda`), on the CPU the plain
    versions mapped over the chunk."""
    if device.type == "cuda":
        st = _POOL.take(device)
        try:
            return exact_decode_cuda(sources, plans, st)
        finally:
            st.stream.synchronize()  # nothing in flight when it is reused
            _POOL.give(device, st)
    with torch.inference_mode():
        return color_resample_reference(
            [_plain_input(s) for s in sources], plans).numpy()


def decode_on_device(source, image_size: int, central_fraction: float,
                     device: torch.device) -> np.ndarray:
    """One image's device stages (:func:`decode_batch` of one) -> uint8
    ``[S, S, 3]`` on the host."""
    return decode_batch([source], [plan_of(source, image_size,
                                           central_fraction)], device)[0]
