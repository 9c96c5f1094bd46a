"""The exact decoder's PNG and BMP readers
(``dl_vqa_tpu_torch.data.image_formats``) against PIL 12.1's ``open`` and
``convert("RGB")``, to the bit, on images made from a numpy seed: every
PNG colour type and bit depth PIL opens, palettes with ``tRNS`` and past
their PLTE, Adam7 interlacing, all five row filters, PIL's own PNGs; BMP
of 1, 4, 8, 16, 24 and 32 bits, BI_BITFIELDS with each mask layout PIL
takes, top-down rows, the core, info, V3, V4 and V5 headers; the
committed format fixtures through the whole reference transform; and the
formats and variants refused, by name."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dl_vqa_tpu_torch.data import image_formats
from dl_vqa_tpu_torch.data.images import UnsupportedImage, decode_image
from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
    FORMAT_FIXTURES, FORMAT_LAYOUTS, load_expected, write_adam7_png)

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body, crc=None):
    crc = zlib.crc32(kind + body) if crc is None else crc
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I",
                                                                    crc)


def _filtered(samples, depth, channels, seed):
    """Rows of ``samples [h, w, c]`` packed at ``depth`` bits, each under a
    filter drawn from a seed."""
    rng = np.random.default_rng(seed)
    bpp = max(1, depth * channels // 8)
    out, prev = bytearray(), None
    for row in samples:
        flat = row.reshape(-1)
        if depth == 16:
            raw = flat.astype(">u2").tobytes()
        elif depth == 8:
            raw = flat.astype(np.uint8).tobytes()
        else:
            per = 8 // depth
            vals = np.concatenate([flat, np.zeros((-len(flat)) % per, int)])
            packed = np.zeros(len(vals) // per, np.uint8)
            for k in range(per):
                packed |= (vals[k::per] << (8 - depth * (k + 1))).astype(
                    np.uint8)
            raw = packed.tobytes()
        cur = np.frombuffer(raw, np.uint8).astype(int)
        up = np.zeros_like(cur) if prev is None else prev
        left = np.concatenate([np.zeros(bpp, int), cur[:-bpp]])[:len(cur)]
        corner = np.concatenate([np.zeros(bpp, int), up[:-bpp]])[:len(cur)]
        kind = int(rng.integers(0, 5))
        if kind == 4:
            pa, pb = np.abs(up - corner), np.abs(left - corner)
            pc = np.abs(left + up - 2 * corner)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, corner))
        else:
            pred = (0, left, up, (left + up) >> 1)[kind]
        out += bytes([kind]) + ((cur - pred) & 255).astype(np.uint8).tobytes()
        prev = cur
    return bytes(out)


def _png(samples, depth, color, interlace=False, palette=None, trns=None):
    h, w, channels = samples.shape
    if interlace:
        data = b"".join(
            _filtered(samples[y0::dy, x0::dx], depth, channels, k)
            for k, (x0, y0, dx, dy) in enumerate(_ADAM7)
            if samples[y0::dy, x0::dx].size)
    else:
        data = _filtered(samples, depth, channels, 9)
    z = zlib.compress(data)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


def _pil(raw):
    with Image.open(io.BytesIO(raw)) as img:
        return np.asarray(img.convert("RGB"))


PNG_KINDS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
             (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6),
             (16, 6)]


@pytest.mark.parametrize("depth,color", PNG_KINDS,
                         ids=[f"depth{d}_type{c}" for d, c in PNG_KINDS])
def test_every_png_colour_type_and_depth_is_pils(depth, color):
    """Each (bit depth, colour type) PIL opens, plain and Adam7, at sizes
    from 1x1 up, with ``tRNS`` (ignored by ``convert("RGB")``) and, for a
    palette, a PLTE shorter than the indices reach (black past it, as
    PIL's palette)."""
    rng = np.random.default_rng(depth * 10 + color)
    for w, h in ((1, 1), (3, 2), (9, 7), (17, 5)):
        samples = rng.integers(0, 1 << depth, (h, w, _CHANNELS[color]))
        if (depth, color) == (16, 0):  # I;16 -> RGB clips, not shifts
            samples[0, 0, 0] = 0x1234
            samples[-1, -1, 0] = 0x80
        palette = trns = None
        if color == 3:
            palette = bytes(rng.integers(0, 256, 3 * min(1 << depth, 5))
                            .astype(np.uint8))
            trns = b"\x00\x10\x80"
        elif color in (0, 2):
            trns = b"\x00\x01" * (1 if color == 0 else 3)
        for interlace in (False, True):
            raw = _png(samples, depth, color, interlace, palette, trns)
            np.testing.assert_array_equal(image_formats.read_png(raw),
                                          _pil(raw),
                                          err_msg=f"{w}x{h} {interlace}")


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "P",
                                  "I;16"])
def test_pils_own_pngs(mode):
    rng = np.random.default_rng(len(mode))
    for w, h in ((1, 1), (5, 3), (33, 20)):
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        if mode == "I;16":
            img = Image.fromarray(rng.integers(0, 600, (h, w)).astype(
                np.uint16))
        elif mode == "P":
            img = Image.fromarray(rgb).quantize(7)
        else:
            img = Image.fromarray(rgb).convert(mode)
        buf = io.BytesIO()
        img.save(buf, "PNG", **({"transparency": 2} if mode == "P" else {}))
        raw = buf.getvalue()
        np.testing.assert_array_equal(image_formats.read_png(raw), _pil(raw))


def test_an_adam7_16_bit_png_as_the_fixture_writer_writes_it():
    rng = np.random.default_rng(7)
    samples = rng.integers(0, 1 << 16, (13, 11, 3)).astype(np.uint16)
    raw = write_adam7_png(samples, 16)
    np.testing.assert_array_equal(image_formats.read_png(raw), _pil(raw))


def _bmp(w, h, bits, rows, header=40, top_down=False, compression=0,
         masks=None, palette=b"", colors=0):
    stride = ((w * bits + 31) >> 3) & ~3
    data = b"".join(bytes(r) + bytes(stride - len(bytes(r)))
                    for r in (rows if top_down else rows[::-1]))
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IIIHHIIiiII", header, w,
                           (2 ** 32 - h) if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, colors, 0)
        if header >= 52 and masks:
            info += struct.pack("<III", *masks[:3])
        if header >= 56 and masks:
            info += struct.pack("<I", masks[3])
        info += bytes(header - len(info))
        if header == 40 and masks:
            info += struct.pack("<III", *masks[:3])
    off = 14 + len(info) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + palette + data)


def _packed_rows(index, bits):
    if bits == 8:
        return [r.astype(np.uint8) for r in index]
    per = 8 // bits
    rows = []
    for r in index:
        v = np.concatenate([r, np.zeros((-len(r)) % per, int)])
        b = np.zeros(len(v) // per, np.uint8)
        for k in range(per):
            b |= (v[k::per] << (8 - bits * (k + 1))).astype(np.uint8)
        rows.append(b)
    return rows


@pytest.mark.parametrize("header,top_down", [
    (12, False), (40, False), (40, True), (56, False), (56, True),
    (108, False), (108, True), (124, False), (124, True)])
def test_every_bmp_depth_and_layout_is_pils(header, top_down):
    """Palettes of 1, 4 and 8 bits (fewer colours than indices), BI_RGB at
    16, 24 and 32 bits, BI_BITFIELDS 5-6-5, 5-5-5 and each 32-bit mask
    layout PIL reads, under each header and row order PIL takes (a core
    header's height has no sign: bottom-up only)."""
    rng = np.random.default_rng(header + top_down)
    for w, h in ((1, 1), (3, 2), (13, 5)):
        for bits in (1, 4, 8):
            ncol = max(2, (1 << bits) - 3)
            palette = bytes(rng.integers(0, 256, ncol * (
                3 if header == 12 else 4)).astype(np.uint8))
            index = rng.integers(0, 1 << bits, (h, w))
            raw = _bmp(w, h, bits, _packed_rows(index, bits), header,
                       top_down, palette=palette,
                       colors=0 if header == 12 else ncol)
            np.testing.assert_array_equal(image_formats.read_bmp(raw),
                                          _pil(raw), err_msg=f"{bits}")
        for bits, compression, masks in (
                (16, 0, None), (24, 0, None), (32, 0, None),
                (16, 3, (0xF800, 0x7E0, 0x1F, 0)),
                (16, 3, (0x7C00, 0x3E0, 0x1F, 0)),
                (32, 3, (0xFF0000, 0xFF00, 0xFF, 0)),
                (32, 3, (0xFF000000, 0xFF0000, 0xFF00, 0)),
                (32, 3, (0xFF000000, 0xFF00, 0xFF, 0)),
                (32, 3, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                (32, 3, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
                (32, 3, (0xFF000000, 0xFF00, 0xFF, 0xFF0000))):
            if header == 12 and compression:
                continue
            if masks and masks[3] and header < 56:
                continue  # no alpha mask before the V3 header
            rows = [rng.integers(0, 256, w * bits // 8).astype(np.uint8)
                    for _ in range(h)]
            raw = _bmp(w, h, bits, rows, header, top_down, compression,
                       masks)
            np.testing.assert_array_equal(image_formats.read_bmp(raw),
                                          _pil(raw),
                                          err_msg=f"{bits} {masks}")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pils_own_bmps(mode):
    rng = np.random.default_rng(len(mode) + 3)
    for w, h in ((1, 1), (5, 3), (31, 9)):
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        img = (Image.fromarray(rgb).quantize(12) if mode == "P"
               else Image.fromarray(rgb).convert(mode))
        buf = io.BytesIO()
        img.save(buf, "BMP")
        raw = buf.getvalue()
        np.testing.assert_array_equal(image_formats.read_bmp(raw), _pil(raw))


@pytest.mark.parametrize("name", list(FORMAT_LAYOUTS))
def test_the_format_fixtures_give_pils_reference_transform(name):
    """Each committed fixture of ``format_fixtures/`` (CMYK, restart and
    progressive JPEGs, RGBA, palette-with-tRNS and Adam7 16-bit PNGs, an
    8-bit and a BI_BITFIELDS BMP) through the whole exact decode equals
    ``expected_formats.npz``, PIL's pixels of the reference transform."""
    import os

    expected = load_expected(os.path.join(FORMAT_FIXTURES,
                                          "expected_formats.npz"))
    with open(os.path.join(FORMAT_FIXTURES, name), "rb") as fd:
        raw = fd.read()
    assert len(raw) < 30 << 10
    np.testing.assert_array_equal(decode_image(raw, 224, 0.875, "exact", -1),
                                  expected[name])


def _gif():
    buf = io.BytesIO()
    Image.new("RGB", (4, 4)).save(buf, "GIF")
    return buf.getvalue()


def _tiff():
    buf = io.BytesIO()
    Image.new("RGB", (4, 4)).save(buf, "TIFF")
    return buf.getvalue()


def _rle_bmp():
    raw = _bmp(4, 2, 8, [np.zeros(4, np.uint8)] * 2, palette=bytes(8),
               colors=2)
    return raw[:30] + struct.pack("<I", 1) + raw[34:]


def _apng():
    raw = _png(np.zeros((2, 2, 3), int), 8, 2)
    at = raw.index(b"IDAT") - 4
    return raw[:at] + _chunk(b"acTL", struct.pack(">II", 1, 0)) + raw[at:]


@pytest.mark.parametrize("make,what", [
    (_gif, "a GIF"), (_tiff, "a TIFF"),
    (lambda: b"RIFF\x10\x00\x00\x00WEBPVP8 ", "a WebP"),
    (_rle_bmp, "an RLE-compressed BMP"), (_apng, "an animated PNG"),
    (lambda: b"hello", "not a JPEG, PNG or BMP"),
], ids=["gif", "tiff", "webp", "rle_bmp", "apng", "unknown"])
def test_formats_it_does_not_take_raise_naming_them(make, what):
    with pytest.raises(UnsupportedImage, match=what):
        decode_image(make(), 32, 0.875, "exact", -1)


def test_damaged_pngs_and_bmps_raise_value_error_naming_the_fault():
    """A bad CRC before the image data raises (PIL checks those chunks);
    a bad CRC on an IDAT does not (PIL does not check it); truncated
    image data raises."""
    samples = np.random.default_rng(1).integers(0, 256, (4, 5, 3))
    raw = _png(samples, 8, 2)
    at = raw.index(b"IHDR") + 17
    bad = raw[:at] + bytes([raw[at] ^ 1]) + raw[at + 1:]
    with pytest.raises(ValueError, match="bad checksum in b'IHDR'"):
        image_formats.read_png(bad)
    idat = raw.index(b"IDAT")
    length = struct.unpack(">I", raw[idat - 4:idat])[0]
    crc_at = idat + 4 + length
    loose = raw[:crc_at] + b"\x00\x00\x00\x00" + raw[crc_at + 4:]
    np.testing.assert_array_equal(image_formats.read_png(loose), _pil(loose))
    short = _chunk(b"IDAT", zlib.compress(b"\x00" * 5))
    with pytest.raises(ValueError, match="truncated PNG"):
        image_formats.read_png(raw[:raw.index(b"IDAT") - 4] + short
                               + _chunk(b"IEND", b""))
    bmp = _bmp(5, 4, 24, [np.zeros(15, np.uint8)] * 4)
    with pytest.raises(ValueError, match="truncated BMP"):
        image_formats.read_bmp(bmp[:-10])


def test_a_png_inflates_only_as_far_as_its_rows():
    """A 1x1 PNG whose image data inflates to 400 MB: the reader takes the
    4 bytes of its one filtered row and stops, as PIL does, in a small
    memory budget."""
    import tracemalloc

    chunk = bytes(1 << 20)
    deflate = zlib.compressobj(9, zlib.DEFLATED, -15)
    deflate.compress(chunk)
    block = deflate.compress(chunk) + deflate.flush(zlib.Z_FULL_FLUSH)
    adler = 1
    for _ in range(400):
        adler = zlib.adler32(chunk, adler)
    stream = (b"\x78\xda" + block * 400 + deflate.flush(zlib.Z_FINISH)
              + struct.pack(">I", adler))
    raw = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", stream) + _chunk(b"IEND", b""))
    tracemalloc.start()
    try:
        rgb = image_formats.read_png(raw)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(rgb, np.zeros((1, 1, 3), np.uint8))
    np.testing.assert_array_equal(rgb, _pil(raw))
    assert peak < 8 << 20, peak
