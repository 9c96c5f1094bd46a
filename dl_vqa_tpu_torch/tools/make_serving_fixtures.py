"""Write the JPEG fixtures of the serving path and PIL's pixels for them.

    python -m dl_vqa_tpu_torch.tools.make_serving_fixtures [--out DIR]

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

The fixtures are committed (``dl_vqa_tpu_torch/tools/fixtures/``), so that
a host with no PIL and no JPEG encoder (the card's) can post them and hold
its decoder to PIL's pixels. PIL is imported inside :func:`main` only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
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
    """``{stem: uint8 [224, 224, 3]}``: PIL's pixels of each fixture."""
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


def main(argv=None) -> int:
    from PIL import Image

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=FIXTURES)
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    expected = {}
    for seed, (name, (w, h, kind, options)) in enumerate(LAYOUTS.items()):
        pixels = (render_photo if kind == "photo" else render)(w, h, seed)
        img = Image.fromarray(pixels)
        if kind == "grey":
            img = img.convert("L")
        path = os.path.join(args.out, f"{name}.jpg")
        img.save(path, "JPEG", **options)
        expected[name] = pil_transform(path)
        print(f"{path}: {w}x{h} {kind} {options} "
              f"{os.path.getsize(path)} bytes")
    np.savez_compressed(os.path.join(args.out, "expected.npz"),
                        **{name: _deltas(pixels)
                           for name, pixels in expected.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
