"""The "exact" image decoder's device stages: PIL's pixels without PIL.

After the host has read a file (``csrc/host/jpeg_entropy.cc`` for a JPEG's
quantized coefficients, :mod:`dl_vqa_tpu_torch.data.image_formats` for a
PNG's or BMP's RGB), three kernels finish the reference transform of
``preprocess_pil_image`` (``dl_vqa_tpu/data/images.py:41-71``) up to its
normalization, to PIL's bits:

* kernel E (``csrc/exact_idct.cu``): dequantization and libjpeg's
  ``jpeg_idct_islow`` (``jidctint.c``), level-shifted and clamped as PIL's
  libjpeg-turbo clamps, a component's coefficients to its plane of
  samples;
* kernel F (``csrc/exact_color.cu``): libjpeg's chroma upsampling
  (``jdsample.c``) and colour conversion (``jdcolor.c``), then PIL's
  ``convert("RGB")``, the planes to RGB8;
* kernel G (``csrc/pil_resample.cu``): Pillow's bilinear
  ``ImagingResample`` of the shorter edge to ``int(S / central_fraction)``
  at the centre crop's pixels only, RGB8 to uint8 ``[S, S, 3]``.

None replaces a TPU kernel: the JAX package runs PIL on the host. Each
has its plain version here (:func:`idct_islow_reference`,
:func:`upsample_color_reference`, :func:`pil_resample_reference`):
integer tensor code vectorized over blocks, rows and pixels, which is the
CPU path and the kernel's oracle to the bit. A decode
(:func:`decode_on_device`) takes the plain versions on the CPU, and on a
card runs an image's three kernels in one call
(:func:`exact_decode_cuda`, ``csrc/exact_pipeline.cu``), which counts the
kernels it launches; nothing falls back. ``exact_idct_cuda``,
``exact_color_cuda`` and ``pil_resample_cuda`` launch one kernel each
(each counting its own launches), for checking a kernel alone against
its plain version.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["GREY", "RGB", "YCBCR", "CMYK", "YCCK", "Component",
           "upsample_method", "idct_islow_reference", "exact_idct_cuda",
           "upsample_color_reference", "exact_color_cuda", "ResamplePlan",
           "resample_plan", "pil_resample_reference", "pil_resample_cuda",
           "StagingPool", "exact_decode_cuda", "decode_on_device"]

# libjpeg's J_COLOR_SPACE values (csrc/host/jpeg_entropy.h).
GREY, RGB, YCBCR, CMYK, YCCK = 1, 2, 3, 4, 5

# Upsampling methods (csrc/exact_color.cu Method).
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


def _upsample(plane: torch.Tensor, c: Component, width: int, height: int
              ) -> torch.Tensor:
    """One component's samples at every output pixel, int64 ``[height,
    width]``, read from its real samples only (the plane's padding never:
    indices are clamped to its real width and height, which also gives the
    replicated edges)."""
    dev = plane.device
    p = plane[:c.height, :c.width].to(torch.int64)
    he, ve = c.max_h // c.h, c.max_v // c.v
    y = torch.arange(height, device=dev)
    x = torch.arange(width, device=dev)

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
    """Plain version of kernel F: the planes of kernel E and their
    components -> uint8 ``[height, width, 3]``, libjpeg's upsampling and
    colour conversion and PIL's ``convert("RGB")`` to the bit."""
    s = [_upsample(p, c, width, height) for p, c in zip(planes, components)]
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


def exact_color_cuda(planes: Sequence[torch.Tensor],
                     components: Sequence[Component], color_space: int,
                     width: int, height: int) -> torch.Tensor:
    """Kernel F; raises on any input it does not take."""
    device = _check_color(planes, components, color_space, width, height)
    if device.type != "cuda":
        raise ValueError(f"kernel F takes CUDA tensors; got {device}")
    planes = [p.contiguous() for p in planes]
    out = torch.empty(height, width, 3, dtype=torch.uint8, device=device)
    pad = 4 - len(planes)

    def field(values):
        return [*values, *[1] * pad]

    lib = _native.library()
    code = lib.vqa_exact_color(
        *[p.data_ptr() for p in planes], *[None] * pad,
        *field(p.shape[1] for p in planes),
        *field(c.width for c in components),
        *field(c.height for c in components),
        *field(c.max_h // c.h for c in components),
        *field(c.max_v // c.v for c in components),
        *field(upsample_method(c) for c in components),
        len(planes), color_space, width, height, out.data_ptr(),
        _native.stream_ptr(device))
    _native.check("exact_color", code)
    exact_color_cuda.launches += 1
    return out


exact_color_cuda.launches = 0


_PRECISION_BITS = 22  # Pillow's Resample.c: 32 - 8 - 2


@dataclass(frozen=True)
class ResamplePlan:
    """Pillow's bilinear taps for the centre crop of one resize: int32
    ``taps`` holding ``[size, 2 + kx]`` for the crop's columns (first
    input column, count, ``kx`` coefficients) then ``[size, 2 + ky]`` for
    its rows, at 22 fraction bits."""
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


def _check_resample(rgb: torch.Tensor, plan: ResamplePlan) -> None:
    if rgb.dtype != torch.uint8 or tuple(rgb.shape) != (plan.in_h,
                                                        plan.in_w, 3):
        raise ValueError(f"expected uint8 [{plan.in_h}, {plan.in_w}, 3]; "
                         f"got {rgb.dtype} {tuple(rgb.shape)}")


def pil_resample_cuda(rgb: torch.Tensor, plan: ResamplePlan,
                      taps: torch.Tensor = None) -> torch.Tensor:
    """Kernel G; raises on any input it does not take. ``taps``: the plan's
    taps already on the card (int32), else they are copied there."""
    _check_resample(rgb, plan)
    if not rgb.is_cuda:
        raise ValueError(f"kernel G takes CUDA tensors; got {rgb.device}")
    rgb = rgb.contiguous()
    if taps is None:
        taps = torch.tensor(plan.taps, device=rgb.device)
    elif (taps.dtype != torch.int32 or taps.device != rgb.device
          or taps.numel() != plan.taps.size or not taps.is_contiguous()):
        raise ValueError("taps must be the plan's int32 taps, contiguous, "
                         "on the image's device")
    out = torch.empty(plan.size, plan.size, 3, dtype=torch.uint8,
                      device=rgb.device)
    code = _native.library().vqa_pil_resample(
        rgb.data_ptr(), plan.in_w, plan.in_h, taps.data_ptr(), plan.kx,
        plan.ky, plan.size, out.data_ptr(), _native.stream_ptr(rgb.device))
    _native.check("pil_resample", code)
    pil_resample_cuda.launches += 1
    return out


pil_resample_cuda.launches = 0


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
            self.host = torch.empty(grown(in_bytes), dtype=torch.uint8
                                    ).pin_memory()
        if self.dev is None or self.dev.numel() < dev_bytes:
            self.dev = torch.empty(grown(dev_bytes), dtype=torch.uint8,
                                   device=self.device)
        if self.out is None or self.out.numel() < out_bytes:
            self.out = torch.empty(grown(out_bytes), dtype=torch.uint8
                                   ).pin_memory()

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


# Eight decodes in flight a card (the online loader's default threads; more
# callers wait for a staging, which a decode holds for its device stages
# only), each staging keeping up to 16 MiB a buffer between decodes: a
# COCO-sized JPEG needs about 2 MiB.
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


def exact_decode_cuda(source, plan: ResamplePlan, st: "_Staging"
                      ) -> np.ndarray:
    """One image's device stages in one call of ``vqa_exact_decode``
    (``csrc/exact_pipeline.cu``): the inputs (a JPEG's coefficients and
    tables, exported by the entropy decoder straight into pinned memory,
    or a PNG's or BMP's RGB8, and the resize's taps) to the card in one
    copy, kernels E and F (a JPEG) and G
    launched through their own C entries on ``st``'s stream, the output
    back through pinned memory and waited for, the interpreter lock given
    up once. ``exact_decode_cuda.launches`` counts the kernels it
    launches, by name: E and F a JPEG, G every image."""
    jpeg = hasattr(source, "export")
    if jpeg:
        width, height, n = source.width, source.height, len(source.shapes)
        if not 1 <= n <= 4:
            raise ValueError(f"a JPEG of {n} components")
        plane_sizes = [bh * bw * 64 for bh, bw in source.shapes]
        # Each component's coefficients, then its table, then the taps.
        sizes = [2 * p for p in plane_sizes] + [128] * n
    else:
        height, width = source.shape[:2]
        plane_sizes, sizes = [], [source.nbytes]
    in_offsets, in_bytes = _layout(sizes + [plan.taps.nbytes])
    out_bytes = plan.size * plan.size * 3
    dev_offsets, dev_bytes = _layout(
        [in_bytes] + plane_sizes + [width * height * 3 if jpeg else 0,
                                    out_bytes])
    st.reserve(in_bytes, dev_bytes, out_bytes)
    host = st.host.numpy()
    if jpeg:
        source.export(st.host.data_ptr(), np.array(
            [at for k in range(n) for at in (in_offsets[k],
                                             in_offsets[n + k])],
            dtype=np.int64))
    else:
        host[:source.nbytes] = np.ascontiguousarray(source).reshape(-1)
    at = in_offsets[-1]
    host[at:at + plan.taps.nbytes] = plan.taps.view(np.uint8)
    dev = st.dev.data_ptr()
    desc = np.zeros(16 + 4 * 11, dtype=np.int64)
    desc[:16] = (
        st.host.data_ptr(), dev, in_bytes, st.out.data_ptr(),
        dev + dev_offsets[-1], out_bytes, int(jpeg), n if jpeg else 0,
        source.color_space if jpeg else 0, width, height,
        dev + (dev_offsets[-2] if jpeg else in_offsets[0]),
        dev + in_offsets[-1], plan.kx, plan.ky, plan.size)
    if jpeg:
        for k, ((bh, bw), comp) in enumerate(zip(source.shapes,
                                                 source.components)):
            desc[16 + 11 * k:27 + 11 * k] = (
                dev + in_offsets[k], dev + in_offsets[n + k],
                dev + dev_offsets[1 + k], bw, bh, bw * 8, comp.width,
                comp.height, comp.max_h // comp.h, comp.max_v // comp.v,
                upsample_method(comp))
    code = _native.library().vqa_exact_decode(desc.ctypes.data,
                                              st.stream.cuda_stream)
    _native.check("exact_decode", code)
    counts = exact_decode_cuda.launches
    with _COUNTS_LOCK:  # decodes run on many threads at once
        if jpeg:
            counts["exact_idct"] += 1
            counts["exact_color"] += 1
        counts["pil_resample"] += 1
    return st.out[:out_bytes].numpy().reshape(plan.size, plan.size,
                                              3).copy()


exact_decode_cuda.launches = {"exact_idct": 0, "exact_color": 0,
                              "pil_resample": 0}
_COUNTS_LOCK = threading.Lock()


def decode_on_device(source, image_size: int, central_fraction: float,
                     device: torch.device) -> np.ndarray:
    """The exact decoder's device stages -> uint8 ``[S, S, 3]`` on the
    host: a JPEG's coefficients and tables (an ``image_formats.JpegData``)
    through kernels E and F, or a PNG's or BMP's RGB8 ``[h, w, 3]``, then
    kernel G: on a CUDA ``device`` in one call on a stream of the decode's
    own (:func:`exact_decode_cuda`), on the CPU in the plain versions."""
    jpeg = hasattr(source, "export")
    width, height = ((source.width, source.height) if jpeg
                     else (source.shape[1], source.shape[0]))
    plan = resample_plan(width, height, image_size, central_fraction)
    if device.type == "cuda":
        st = _POOL.take(device)
        try:
            return exact_decode_cuda(source, plan, st)
        finally:
            st.stream.synchronize()  # nothing in flight when it is reused
            _POOL.give(device, st)
    with torch.inference_mode():
        if jpeg:
            planes = [idct_islow_reference(torch.from_numpy(c),
                                           torch.from_numpy(q))
                      for c, q in zip(source.coefficients, source.qtables)]
            rgb = upsample_color_reference(planes, source.components,
                                           source.color_space, width, height)
        else:
            rgb = torch.from_numpy(source)
        return pil_resample_reference(rgb, plan).numpy()
