"""The host side of the "exact" decoder: a file's bytes to what the card
finishes, as Pillow 12.1 opens the file, without PIL.

* :func:`sniff` names a file's format by its first bytes (JPEG, PNG and
  BMP are decoded; GIF, TIFF, WebP and the like are named in the refusal).
* :func:`read_jpeg`: the entropy decoder of ``csrc/host/jpeg_entropy.cc``
  (host library ``exact``; the interpreter lock released while it runs)
  -> :class:`JpegData`, each component's quantized coefficients and
  quantization table, which kernels E and F
  (:mod:`dl_vqa_tpu_torch.ops.exact_decode`) turn into RGB.
* :func:`read_png` and :func:`read_bmp` -> RGB8 ``[h, w, 3]``, as PIL's
  ``Image.open(...).convert("RGB")`` gives it: PNG of colour types 0, 2,
  3, 4 and 6 at every bit depth PIL reads, Adam7 interlacing, ``tRNS``
  (which ``convert("RGB")`` ignores, as it drops alpha without
  compositing), chunk CRCs checked where PIL checks them (every chunk
  before the first IDAT); BMP with BITMAPCOREHEADER, BITMAPINFOHEADER and
  its V2 to V5 successors, palettes of 1, 4 and 8 bits, BI_RGB at 16, 24
  and 32 bits and BI_BITFIELDS with the masks PIL takes, rows bottom-up
  or top-down. PIL's own quirks are kept: 16-bit samples by their high
  byte, 16-bit grey clipped to 255 (``I;16`` -> ``RGB``), 2- and 4-bit
  grey scaled to 0-255, a palette index past the palette black, a BMP
  whose palette is PIL's grey ramp read as grey.

What this does not take raises :class:`UnsupportedImage`, naming the
format or the variant (RLE BMP, an animated PNG, GIF, TIFF, WebP, ...);
a damaged file raises ``ValueError`` naming the fault. Nothing here
imports PIL.
"""

from __future__ import annotations

import ctypes
import zlib
from typing import List, Optional

import numpy as np

from dl_vqa_tpu_torch.ops.exact_decode import Component

__all__ = ["UnsupportedImage", "MAX_PIXELS", "sniff", "JpegData",
           "read_jpeg", "read_png", "read_bmp", "read_rgb"]

# PIL's DecompressionBombError threshold (2 * MAX_IMAGE_PIXELS), the
# decoders' cap (csrc/host/resample.h kMaxPixels).
MAX_PIXELS = 178956970


class UnsupportedImage(ValueError):
    """Bytes in a format, or a variant of one, that the port's decoders do
    not take (the serving fronts answer 415)."""


_OTHER_FORMATS = ((b"GIF87a", "a GIF"), (b"GIF89a", "a GIF"),
                  (b"II*\x00", "a TIFF"), (b"MM\x00*", "a TIFF"),
                  (b"\x00\x00\x01\x00", "an ICO"), (b"8BPS", "a PSD"),
                  (b"\x97JB2", "a JBIG2"), (b"\x00\x00\x00\x0cjP", "a JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "a JPEG 2000"))


def sniff(raw: bytes) -> str:
    """``"jpeg"``, ``"png"`` or ``"bmp"`` by the magic bytes (a JPEG's
    start-of-image marker, as libjpeg and the native front test it);
    otherwise raises :class:`UnsupportedImage` naming what the bytes look
    like."""
    if len(raw) >= 3 and raw[0] == 0xFF and raw[1] == 0xD8:
        return "jpeg"
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if raw[:2] == b"BM":
        return "bmp"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        raise UnsupportedImage("a WebP image: dl_vqa_tpu_torch decodes "
                               "JPEG, PNG and BMP")
    for magic, name in _OTHER_FORMATS:
        if raw.startswith(magic):
            raise UnsupportedImage(f"{name} image: dl_vqa_tpu_torch "
                                   "decodes JPEG, PNG and BMP")
    raise UnsupportedImage("not a JPEG, PNG or BMP image")


class JpegData:
    """A JPEG's quantized DCT coefficients, as libjpeg hands them to its
    inverse DCT, held by the entropy decoder (its C++ result, freed by
    :meth:`close` or when this goes): the frame's size, libjpeg's colour
    space (``ops.exact_decode.GREY`` ... ``YCCK``), each component's
    :class:`Component` and ``shapes`` ``(blocks_h, blocks_w)``; on demand
    ``coefficients``, int16 ``[blocks_h, blocks_w, 64]`` a component
    (natural order, padded to whole MCUs), and ``qtables``, ``[64]`` each
    (int16 holding libjpeg's uint16 values), as numpy copies; or
    :meth:`export` copies both into memory of the caller's, in C++."""

    def __init__(self, lib, handle, what: str):
        self._lib, self._handle = lib, handle
        if not handle:
            raise MemoryError(f"{what}: no memory to decode it")
        try:
            message = ctypes.create_string_buffer(256)
            status = lib.vqa_torch_jpeg_status(handle, message,
                                               len(message))
            text = message.value.decode(errors="replace")
            if status == _JPEG_NOT:
                raise UnsupportedImage(f"{what} is not a JPEG")
            if status == _JPEG_UNSUPPORTED:
                raise UnsupportedImage(f"{what}: {text}: the exact decoder "
                                       "does not take it")
            if status != _JPEG_OK:
                raise ValueError(f"{what}: a damaged JPEG ({text})")
        except BaseException:
            self.close()
            raise
        head = np.zeros(40, dtype=np.int32)
        lib.vqa_torch_jpeg_header(handle, head.ctypes.data)
        (self.width, self.height, ncomp, self.color_space, max_h,
         max_v) = (int(v) for v in head[:6])
        self.components, self.shapes = [], []
        for c in range(ncomp):
            h, v, bw, bh, cw, ch = (int(x) for x in head[8 + 8 * c:14 + 8 * c])
            self.components.append(Component(h, v, cw, ch, max_h, max_v))
            self.shapes.append((bh, bw))
        self._arrays = None

    def _copies(self):
        if self._arrays is None:
            coefs, tables = [], []
            for c, (bh, bw) in enumerate(self.shapes):
                ptr = self._lib.vqa_torch_jpeg_coefficients(self._handle, c)
                coefs.append(np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int16)),
                    (bh * bw * 64,)).reshape(bh, bw, 64).copy())
                table = self._lib.vqa_torch_jpeg_qtable(self._handle, c)
                tables.append(np.ctypeslib.as_array(
                    ctypes.cast(table, ctypes.POINTER(ctypes.c_int16)),
                    (64,)).copy())
            self._arrays = coefs, tables
        return self._arrays

    @property
    def coefficients(self) -> List[np.ndarray]:
        return self._copies()[0]

    @property
    def qtables(self) -> List[np.ndarray]:
        return self._copies()[1]

    def export(self, dest: int, offsets: np.ndarray) -> None:
        """Each component's coefficients to ``dest + offsets[2 c]`` and its
        table to ``dest + offsets[2 c + 1]`` (int64 ``offsets``; ``dest``
        a host address holding them), one C++ copy."""
        self._lib.vqa_torch_jpeg_export(self._handle, dest,
                                        offsets.ctypes.data)

    def close(self) -> None:
        if self._handle:
            self._lib.vqa_torch_jpeg_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


# csrc/host/jpeg_entropy.h JpegStatus.
_JPEG_OK, _JPEG_NOT, _JPEG_UNSUPPORTED = 0, 2, 4


def _library():
    from dl_vqa_tpu_torch.ops import _host

    return _host.library("exact")


def read_jpeg(raw: bytes, what: str = "the image") -> JpegData:
    """A JPEG's bytes -> :class:`JpegData` (the entropy decoder on the
    host, the interpreter lock released while it runs); raises naming
    ``what``."""
    lib = _library()
    return JpegData(lib, lib.vqa_torch_jpeg_parse(raw, len(raw)), what)


def _check_size(width: int, height: int, what: str) -> None:
    if width < 1 or height < 1:
        raise ValueError(f"{what}: an empty image ({width}x{height})")
    if width * height > MAX_PIXELS:
        raise UnsupportedImage(f"{what}: {width}x{height} is more pixels "
                               "than the decoders' cap")


# (bit depth, colour type) -> channels, as PngImagePlugin._MODES lists
# what PIL opens.
_PNG_CHANNELS = {(1, 0): 1, (2, 0): 1, (4, 0): 1, (8, 0): 1, (16, 0): 1,
                 (8, 2): 3, (16, 2): 3, (1, 3): 1, (2, 3): 1, (4, 3): 1,
                 (8, 3): 1, (8, 4): 2, (16, 4): 2, (8, 6): 4, (16, 6): 4}
# Adam7: (first column, first row, step across, step down) of each pass.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _be32(raw: bytes, at: int) -> int:
    return int.from_bytes(raw[at:at + 4], "big")


def _png_samples(data: bytes, width: int, height: int, depth: int,
                 channels: int, what: str) -> np.ndarray:
    """One (sub)image of filtered rows -> its samples, uint16 ``[height,
    width, channels]`` (unfiltered in C++, then unpacked)."""
    row_bytes = (width * depth * channels + 7) // 8
    out = np.empty(height * row_bytes, dtype=np.uint8)
    code = _library().vqa_torch_png_unfilter(
        data, len(data), height, row_bytes,
        max(1, depth * channels // 8), out.ctypes.data)
    if code == 2:
        raise ValueError(f"{what}: a truncated PNG (its image data ends "
                         "early)")
    if code:
        raise ValueError(f"{what}: a damaged PNG (a filter type above 4)")
    rows = out.reshape(height, row_bytes)
    if depth == 16:
        return rows.view(">u2").reshape(height, width, channels).astype(
            np.uint16)
    if depth == 8:
        return rows.reshape(height, width, channels).astype(np.uint16)
    bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint16)
    values = (bits * weights).sum(axis=2, dtype=np.uint16)
    return values[:, :width, None]


def _png_to_rgb(samples: np.ndarray, depth: int, color: int,
                palette: Optional[np.ndarray]) -> np.ndarray:
    """Samples -> RGB8 as PIL opens and ``convert("RGB")``s them."""
    if color == 3:
        return palette[samples[..., 0]]
    if depth == 16:
        if color == 0:  # I;16 -> RGB clips
            grey = np.minimum(samples[..., 0], 255).astype(np.uint8)
            return np.repeat(grey[..., None], 3, axis=2)
        samples = samples >> 8  # the high byte (RGB;16B, LA;16B, RGBA;16B)
    elif depth < 8:  # 1: 0 or 255; 2: x 85; 4: x 17 (L;2, L;4)
        samples = samples * (255 // ((1 << depth) - 1))
    samples = samples.astype(np.uint8)
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def read_png(raw: bytes, what: str = "the image") -> np.ndarray:
    """A PNG's bytes -> RGB8 ``[h, w, 3]``, as Pillow opens and
    ``convert("RGB")``s it."""
    if raw[:8] != b"\x89PNG\r\n\x1a\n":
        raise UnsupportedImage(f"{what} is not a PNG")
    pos, header, palette, idat = 8, None, None, []
    seen_idat = False
    while True:
        if pos + 8 > len(raw):
            if seen_idat:
                break  # the data ends after the image data
            raise ValueError(f"{what}: a truncated PNG")
        length, kind = _be32(raw, pos), raw[pos + 4:pos + 8]
        body = raw[pos + 8:pos + 8 + length]
        if len(body) < length:
            raise ValueError(f"{what}: a truncated PNG ({kind!r} chunk)")
        if kind == b"IDAT":
            idat.append(body)
            seen_idat = True
        elif seen_idat:
            break  # PIL reads the image data up to the first other chunk
        else:  # PIL checks the CRC of every chunk before the first IDAT
            crc = raw[pos + 8 + length:pos + 12 + length]
            if len(crc) < 4 or zlib.crc32(kind + body) != _be32(crc, 0):
                raise ValueError(f"{what}: a broken PNG (bad checksum in "
                                 f"{kind!r})")
            if kind == b"IHDR":
                if length < 13:
                    raise ValueError(f"{what}: a truncated IHDR chunk")
                header = body
            elif kind == b"PLTE":
                palette = body
            elif kind == b"acTL":
                raise UnsupportedImage(f"{what}: an animated PNG (APNG)")
            elif kind == b"IEND":
                raise ValueError(f"{what}: a PNG with no image data")
        pos += 12 + length
    if header is None:
        raise ValueError(f"{what}: a PNG with no IHDR chunk")
    width, height = _be32(header, 0), _be32(header, 4)
    depth, color, method, filtering, interlace = header[8:13]
    if (depth, color) not in _PNG_CHANNELS:
        raise UnsupportedImage(f"{what}: a PNG of bit depth {depth} and "
                               f"colour type {color}, which PIL does not "
                               "open")
    if method != 0 or filtering != 0 or interlace > 1:
        raise ValueError(f"{what}: a PNG with an unknown compression, "
                         "filter or interlace method")
    _check_size(width, height, what)
    channels = _PNG_CHANNELS[(depth, color)]
    if color == 3:
        if palette is None:
            raise ValueError(f"{what}: a palette PNG with no PLTE chunk")
        entries = np.frombuffer(palette[:768], dtype=np.uint8)
        table = np.zeros((256, 3), dtype=np.uint8)  # past the palette: 0
        n = len(entries) // 3
        table[:n] = entries[:3 * n].reshape(n, 3)
        palette = table
    passes = ([(0, 0, 1, 1, width, height)] if not interlace else
              [(x0, y0, dx, dy, -(-(width - x0) // dx),
                -(-(height - y0) // dy)) for x0, y0, dx, dy in _ADAM7])
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    sizes = [ph * (1 + (pw * depth * channels + 7) // 8)
             for _, _, _, _, pw, ph in passes]
    try:
        # Inflated only as far as the filtered rows reach, as PIL stops at
        # the image's size: a small stream may inflate a thousandfold.
        data = zlib.decompressobj().decompress(b"".join(idat), sum(sizes))
    except zlib.error as exc:
        raise ValueError(f"{what}: a damaged PNG ({exc})") from None
    if not interlace:
        samples = _png_samples(data, width, height, depth, channels, what)
    else:
        samples = np.zeros((height, width, channels), dtype=np.uint16)
        at = 0
        for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
            samples[y0::dy, x0::dx] = _png_samples(
                data[at:at + size], pw, ph, depth, channels, what)
            at += size
    return _png_to_rgb(samples, depth, color, palette)


# BmpImagePlugin's raw modes: bit depth -> (mode, raw mode).
_BMP_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
              32: "BGRX"}
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# 4-byte raw modes: the byte of R, G and B in each pixel.
_BMP_BYTES = {"BGRX": (2, 1, 0), "XBGR": (3, 2, 1), "BGXR": (3, 1, 0),
              "ABGR": (3, 2, 1), "RGBA": (0, 1, 2), "BGRA": (2, 1, 0),
              "BGAR": (3, 1, 0)}


def _le(raw: bytes, at: int, n: int) -> int:
    if at + n > len(raw):
        raise ValueError("a truncated BMP header")
    return int.from_bytes(raw[at:at + n], "little")


def read_bmp(raw: bytes, what: str = "the image") -> np.ndarray:
    """A BMP's bytes -> RGB8 ``[h, w, 3]``, as Pillow's BmpImagePlugin
    opens it and ``convert("RGB")`` converts it."""
    if raw[:2] != b"BM":
        raise UnsupportedImage(f"{what} is not a BMP")
    try:
        return _read_bmp(raw, what)
    except ValueError as exc:
        if isinstance(exc, UnsupportedImage) or str(exc).startswith(what):
            raise
        raise ValueError(f"{what}: {exc}") from None


def _read_bmp(raw: bytes, what: str) -> np.ndarray:
    offset = _le(raw, 10, 4)
    header_size = _le(raw, 14, 4)
    pos = 14 + header_size  # the file position after the header
    masks = None
    if header_size == 12:  # BITMAPCOREHEADER
        width, height = _le(raw, 18, 2), _le(raw, 20, 2)
        bits, compression, colors, padding = _le(raw, 24, 2), 0, 0, 3
        top_down = False
    elif header_size in (40, 52, 56, 64, 108, 124):
        head = raw[18:14 + header_size]
        if len(head) < header_size - 4:
            raise ValueError("a truncated BMP header")
        top_down = head[7] == 0xFF
        width = _le(head, 0, 4)
        height = 2 ** 32 - _le(head, 4, 4) if top_down else _le(head, 4, 4)
        bits, compression = _le(head, 10, 2), _le(head, 12, 4)
        colors, padding = _le(head, 28, 4), 4
        if compression == 3:  # BI_BITFIELDS
            if len(head) >= 48:
                masks = [_le(head, 36 + 4 * i, 4)
                         for i in range(4 if len(head) >= 52 else 3)]
            else:  # after a 40-byte header, in the file
                masks = [_le(raw, pos + 4 * i, 4) for i in range(3)]
                pos += 12
            masks += [0] * (4 - len(masks))
    else:
        raise UnsupportedImage(f"{what}: a BMP with a {header_size}-byte "
                               "header, which PIL does not open")
    _check_size(width, height, what)
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_MODES:
        raise UnsupportedImage(f"{what}: a BMP of {bits} bits a pixel")
    raw_mode = _BMP_MODES[bits]
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _BMP_MASKS:
            raise UnsupportedImage(f"{what}: a BMP bitfields layout PIL does "
                                   f"not open ({bits} bits, masks "
                                   f"{[hex(m) for m in masks]})")
        raw_mode = _BMP_MASKS[key]
    elif compression in (1, 2):
        raise UnsupportedImage(f"{what}: an RLE-compressed BMP")
    elif compression != 0:
        raise UnsupportedImage(f"{what}: a BMP of compression "
                               f"{compression}")
    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"a BMP palette of {colors} colours")
        table = raw[pos:pos + padding * colors]
        pos += padding * colors
        grey_values = (0, 255) if colors == 2 else range(colors)
        grey = all(table[i * padding:i * padding + 3] == bytes([v]) * 3
                   for i, v in enumerate(grey_values))
        if grey and bits != (1 if colors == 2 else 8):
            # PIL reads it with the raw mode "1" or "L" at another depth.
            raise UnsupportedImage(f"{what}: a {bits}-bit BMP whose palette "
                                   "is PIL's grey ramp of another depth")
        if grey and bits == 8:
            palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3,
                                axis=1)  # mode L: the index is the value
        else:
            entries = np.frombuffer(table, dtype=np.uint8)
            n = len(entries) // padding
            palette = np.zeros((256, 3), dtype=np.uint8)
            palette[:min(n, 256)] = entries[:padding * n].reshape(
                n, padding)[:256, 2::-1]
    stride = ((width * bits + 31) >> 3) & ~3
    start = offset or pos
    data = raw[start:start + stride * height]
    if len(data) < stride * height:
        raise ValueError("a truncated BMP (its pixel data ends early)")
    rows = np.frombuffer(data, dtype=np.uint8).reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bits <= 8:
        if bits == 8:
            index = rows[:, :width]
        else:
            per = 8 // bits
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            index = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)
                     ).reshape(height, stride * per)[:, :width]
        return palette[index]
    if bits == 16:  # Pillow's BGR;15 and BGR;16 unpackers
        pixel = rows[:, :2 * width].view("<u2").astype(np.int64)
        b = (pixel & 31) * 255 // 31
        if raw_mode == "BGR;16":
            g = ((pixel >> 5) & 63) * 255 // 63
            r = ((pixel >> 11) & 31) * 255 // 31
        else:
            g = ((pixel >> 5) & 31) * 255 // 31
            r = ((pixel >> 10) & 31) * 255 // 31
        return np.stack([r, g, b], axis=-1).astype(np.uint8)
    if bits == 24:
        return np.ascontiguousarray(
            rows[:, :3 * width].reshape(height, width, 3)[:, :, ::-1])
    pixels = rows[:, :4 * width].reshape(height, width, 4)
    return np.ascontiguousarray(pixels[:, :, list(_BMP_BYTES[raw_mode])])


def read_rgb(raw: bytes, kind: str, what: str = "the image") -> np.ndarray:
    """A PNG's or BMP's bytes (``kind`` from :func:`sniff`) -> RGB8."""
    if kind == "png":
        return read_png(raw, what)
    if kind == "bmp":
        return read_bmp(raw, what)
    raise ValueError(f"read_rgb takes png or bmp, got {kind!r}")
