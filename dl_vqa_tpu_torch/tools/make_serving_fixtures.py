"""Write the image fixtures of the serving path and PIL's pixels for them.

    python -m dl_vqa_tpu_torch.tools.make_serving_fixtures [--out DIR]
        [--formats]

Renders four images from a seed and encodes them with PIL in the layouts
a decoder must handle: 4:2:0, 4:2:2 and 4:4:4 chroma, greyscale,
progressive, optimized Huffman tables, landscape, portrait and odd sizes,
two smaller than the resize target. One of them (:data:`LOAD_FIXTURE`)
has the pixels of a VQA 2.0 request, COCO's common 640x480, 4:2:0 at
quality 90, with a photograph's texture (a 1/f noise spectrum over the
shapes); at 63,852 bytes it is smaller than COCO's mean file (about 160
KB). The serving fronts' closed-loop load posts it. The others are small,
with smooth gradients and hard-edged shapes.

Beside them, ``expected.npz`` holds PIL's reference transform of each
(``dl_vqa_tpu/data/images.py::preprocess_pil_image`` before its
normalization: the bilinear resize of the shorter edge to
``int(224 / 0.875)`` and the centre crop) as uint8 ``[224, 224, 3]``,
keyed by the file's stem; each is stored as planes of G, R - G and B - G,
each as its differences down and across, mod 256, which deflate packs
into 7 to 41% of the pixels' bytes (:func:`load_expected` undoes both).
The whole directory stays under 200 KB.

In ``format_fixtures/`` beside that directory, :data:`FORMAT_LAYOUTS`
are eight small files in the other layouts the exact decoder takes, each
under 30 KB: a CMYK JPEG (PIL's
Adobe marker), a JPEG with a restart interval, a progressive 4:2:0 JPEG
of several refinement scans, an RGBA PNG, a palette PNG with ``tRNS``, an
Adam7-interlaced 16-bit RGB PNG (written here: PIL writes no interlaced
PNG), an 8-bit palette BMP and a 32-bit BI_BITFIELDS BMP with a V5 header
(written here). Their PIL pixels are in ``expected_formats.npz``, in the
same packing (:func:`load_expected` reads both). ``--formats`` writes only
these and ``expected_formats.npz``, leaving the JPEG fixtures and
``expected.npz`` as they are.

The fixtures are committed (``dl_vqa_tpu_torch/tools/fixtures/``), so that
a host with no PIL and no encoder (the card's) can post them and hold its
decoders to PIL's pixels. PIL is imported inside :func:`main` only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FORMAT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "format_fixtures")
IMAGE_SIZE = 224
CENTRAL_FRACTION = 0.875

# name -> (width, height, what is rendered: "shapes", "grey" or "photo",
# save options)
LAYOUTS = {
    "coco_640x480_420": (640, 480, "photo",
                         {"quality": 90, "subsampling": 2}),
    "portrait_422": (181, 263, "shapes",
                     {"quality": 92, "subsampling": 1, "optimize": True}),
    "grey": (250, 250, "grey", {"quality": 90}),
    "wide_progressive_444": (480, 270, "shapes",
                             {"quality": 75, "subsampling": 0,
                              "progressive": True}),
}
LOAD_FIXTURE = "coco_640x480_420"  # what the closed-loop clients post

# file name -> (width, height, what is rendered, how it is written: PIL's
# save options, or "adam7_rgb16" / "bmp_bitfields32" for the writers
# below)
FORMAT_LAYOUTS = {
    "cmyk_adobe.jpg": (96, 72, "shapes", {"quality": 90}),
    "restart_422.jpg": (150, 100, "shapes",
                        {"quality": 85, "subsampling": 1,
                         "restart_marker_blocks": 3}),
    "progressive_420.jpg": (203, 141, "shapes",
                            {"quality": 80, "subsampling": 2,
                             "progressive": True}),
    "rgba.png": (90, 70, "shapes", {}),
    "palette_trns.png": (101, 77, "shapes", {}),
    "interlaced_rgb16.png": (61, 45, "shapes", "adam7_rgb16"),
    "palette8.bmp": (117, 83, "shapes", {}),
    "bitfields32.bmp": (70, 52, "shapes", "bmp_bitfields32"),
}


def render(width: int, height: int, seed: int) -> np.ndarray:
    """uint8 ``[height, width, 3]``: a diagonal colour gradient and a few
    hard-edged rectangles and discs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    base = rng.uniform(0, 255, 3)
    slope = rng.uniform(-1, 1, (3, 2)) * 200
    img = np.stack([base[c] + slope[c, 0] * x / width
                    + slope[c, 1] * y / height for c in range(3)], axis=-1)
    for _ in range(4):
        colour = rng.uniform(0, 255, 3)
        cx, cy = rng.uniform(0, width), rng.uniform(0, height)
        r = rng.uniform(0.1, 0.3) * min(width, height)
        if rng.random() < 0.5:
            mask = (np.abs(x - cx) < r) & (np.abs(y - cy) < r / 2)
        else:
            mask = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[mask] = colour
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def render_photo(width: int, height: int, seed: int) -> np.ndarray:
    """uint8 ``[height, width, 3]``: :func:`render`'s shapes under a
    photograph's texture, noise whose power falls as 1/f^2.8 with
    frequency, shared in part by the three channels."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(height)[:, None]
    fx = np.fft.rfftfreq(width)[None, :]
    f = np.hypot(fx, fy)
    f[0, 0] = 1.0
    amp = f ** -1.4
    amp[0, 0] = 0.0

    def noise():
        phase = np.exp(2j * np.pi * rng.random(amp.shape))
        n = np.fft.irfft2(amp * phase, s=(height, width))
        return n / n.std()

    luma = noise()
    texture = np.stack([0.8 * luma + 0.35 * noise() for _ in range(3)], -1)
    img = 0.4 * render(width, height, seed) + 0.6 * (128 + 45 * texture)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def pil_transform(path: str) -> np.ndarray:
    """PIL's reference transform of one file, as uint8 HWC (the arithmetic
    of ``preprocess_pil_image`` before its normalization)."""
    from PIL import Image

    target = int(IMAGE_SIZE / CENTRAL_FRACTION)
    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        if w <= h:
            size = (target, int(target * h / w))
        else:
            size = (int(target * w / h), target)
        img = img.resize(size, Image.BILINEAR)
        w, h = img.size
        left = int(round((w - IMAGE_SIZE) / 2.0))
        top = int(round((h - IMAGE_SIZE) / 2.0))
        img = img.crop((left, top, left + IMAGE_SIZE, top + IMAGE_SIZE))
        return np.asarray(img, dtype=np.uint8)


def load_expected(path: str = os.path.join(FIXTURES, "expected.npz")
                  ) -> dict:
    """``{key: uint8 [224, 224, 3]}``: PIL's pixels of each fixture (the
    JPEG fixtures' stems in ``expected.npz``, the other layouts' file
    names in ``expected_formats.npz``)."""
    out = {}
    with np.load(path) as deltas:
        for name in deltas.files:
            g, r, b = np.cumsum(np.cumsum(deltas[name], axis=1,
                                          dtype=np.uint8),
                                axis=2, dtype=np.uint8)
            out[name] = np.stack([r + g, g, b + g], axis=-1)
    return out


def _deltas(pixels: np.ndarray) -> np.ndarray:
    """What :func:`load_expected` undoes: uint8 ``[3, H, W]``, the planes
    G, R - G, B - G, each differenced down and across (uint8: mod 256)."""
    r, g, b = pixels.transpose(2, 0, 1)
    planes = np.stack([g, r - g, b - g])
    return np.diff(np.diff(planes, axis=1, prepend=np.uint8(0)), axis=2,
                   prepend=np.uint8(0))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import zlib

    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def write_adam7_png(samples: np.ndarray, depth: int) -> bytes:
    """An Adam7-interlaced truecolour PNG (colour type 2) of ``samples``
    ``[h, w, 3]`` at ``depth`` 8 or 16, each row's filter the one of the
    five that its row number picks (so that all five are exercised)."""
    import zlib

    h, w, _ = samples.shape
    bpp = 3 * depth // 8
    data = bytearray()
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        prev = None
        for y, row in enumerate(sub):
            cur = np.frombuffer(row.astype(">u2" if depth == 16 else np.uint8
                                           ).tobytes(), np.uint8).astype(int)
            up = np.zeros_like(cur) if prev is None else prev
            left = np.concatenate([np.zeros(bpp, int), cur[:-bpp]])
            corner = np.concatenate([np.zeros(bpp, int), up[:-bpp]])
            kind = y % 5
            if kind == 4:  # Paeth
                pa, pb = np.abs(up - corner), np.abs(left - corner)
                pc = np.abs(left + up - 2 * corner)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, up, corner))
            else:
                pred = (0, left, up, (left + up) >> 1)[kind]
            data += bytes([kind]) + ((cur - pred) & 255).astype(
                np.uint8).tobytes()
            prev = cur
    header = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
              + bytes([depth, 2, 0, 0, 1]))
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(bytes(data), 9))
            + _png_chunk(b"IEND", b""))


def write_bitfields_bmp(pixels: np.ndarray) -> bytes:
    """A 32-bit BI_BITFIELDS BMP with a BITMAPV5HEADER of RGBA ``pixels``
    ``[h, w, 4]``, top-down, its masks R 0xFF, G 0xFF00, B 0xFF0000, A
    0xFF000000 (PIL's raw mode "RGBA")."""
    import struct

    h, w, _ = pixels.shape
    data = pixels.astype(np.uint8).tobytes()
    info = struct.pack("<IiiHHIIiiII", 124, w, -h, 1, 32, 3, len(data),
                       2835, 2835, 0, 0)
    info += struct.pack("<IIII", 0xFF, 0xFF00, 0xFF0000, 0xFF000000)
    info += bytes(124 - len(info))
    head = b"BM" + struct.pack("<IHHI", 14 + len(info) + len(data), 0, 0,
                               14 + len(info))
    return head + info + data


def _format_fixture(name: str, pixels: np.ndarray, how, path: str) -> None:
    from PIL import Image

    if how == "adam7_rgb16":
        wide = pixels.astype(np.uint16) * 257 + np.arange(
            pixels.size, dtype=np.uint16).reshape(pixels.shape) % 251
        with open(path, "wb") as fd:
            fd.write(write_adam7_png(wide, 16))
        return
    if how == "bmp_bitfields32":
        alpha = np.linspace(0, 255, pixels.shape[1], dtype=np.uint8)
        rgba = np.concatenate([pixels, np.broadcast_to(
            alpha[None, :, None], pixels.shape[:2] + (1,))], axis=2)
        with open(path, "wb") as fd:
            fd.write(write_bitfields_bmp(rgba))
        return
    img = Image.fromarray(pixels)
    if name.startswith("cmyk"):
        img = img.convert("CMYK")
    elif name == "rgba.png":
        img = img.convert("RGBA")
        img.putalpha(Image.fromarray(pixels[..., 0]))
    elif name.startswith("palette"):
        img = img.quantize(64 if name.endswith(".png") else 200)
        if name.endswith(".png"):
            how = dict(how, transparency=bytes(range(0, 256, 4)))
    img.save(path, **how)


def main(argv=None) -> int:
    from PIL import Image

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=FIXTURES)
    parser.add_argument("--formats-out", default=FORMAT_FIXTURES)
    parser.add_argument("--formats", action="store_true",
                        help="write only the other layouts' fixtures and "
                             "expected_formats.npz")
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    expected = {}
    for seed, (name, (w, h, kind, options)) in enumerate(LAYOUTS.items()):
        if args.formats:
            break
        pixels = (render_photo if kind == "photo" else render)(w, h, seed)
        img = Image.fromarray(pixels)
        if kind == "grey":
            img = img.convert("L")
        path = os.path.join(args.out, f"{name}.jpg")
        img.save(path, "JPEG", **options)
        expected[name] = pil_transform(path)
        print(f"{path}: {w}x{h} {kind} {options} "
              f"{os.path.getsize(path)} bytes")
    if not args.formats:
        np.savez_compressed(os.path.join(args.out, "expected.npz"),
                            **{name: _deltas(pixels)
                               for name, pixels in expected.items()})
    formats = {}
    os.makedirs(args.formats_out, exist_ok=True)
    for seed, (name, (w, h, kind, how)) in enumerate(FORMAT_LAYOUTS.items(),
                                                     start=len(LAYOUTS)):
        pixels = (render_photo if kind == "photo" else render)(w, h, seed)
        path = os.path.join(args.formats_out, name)
        _format_fixture(name, pixels, how, path)
        formats[name] = pil_transform(path)
        size = os.path.getsize(path)
        if size >= 30 << 10:
            raise SystemExit(f"{path}: {size} bytes, over 30 KB")
        print(f"{path}: {w}x{h} {kind} {how} {size} bytes")
    np.savez_compressed(os.path.join(args.formats_out,
                                     "expected_formats.npz"),
                        **{name: _deltas(pixels)
                           for name, pixels in formats.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
