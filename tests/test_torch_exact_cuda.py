"""Kernel E and ``color_resample`` (kernels F and G of the first design in
one launch over a batch) of the exact decoder against their plain
versions, on the card, to the bit: every sampling layout and colour space
of small JPEGs written by ``tests/jpeg_writer.py``, resizes down and up,
a mixed chunk against the one-by-one results, large images whose tiles
shrink (and, at the largest the decoder accepts, whose rectangles go in
strips), and the whole decode of the committed fixtures, one by one and
as a list. Every test here needs a GPU and skips without one. This file
imports no JAX:

    python -m pytest --noconftest tests/test_torch_exact_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.data import image_formats
from dl_vqa_tpu_torch.data.images import (
    EXACT_CHUNK, decode_image, decode_image_files)
from dl_vqa_tpu_torch.ops import exact_decode
from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
    FIXTURES, FORMAT_FIXTURES, FORMAT_LAYOUTS, LAYOUTS, load_expected)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jpeg_writer import JFIF, adobe, write_jpeg  # noqa: E402


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


LAYOUTS_WRITTEN = {
    "444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
    "440": [(1, 2), (1, 1), (1, 1)], "420": [(2, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)], "grey": [(1, 1)],
    "ycck": [(2, 2), (1, 1), (1, 1), (2, 2)],
}


@pytest.mark.parametrize("layout", list(LAYOUTS_WRITTEN))
def test_kernels_e_and_f_equal_their_plain_versions(device, layout):
    factors = LAYOUTS_WRITTEN[layout]
    rng = np.random.default_rng(len(layout))
    for w, h in ((1, 1), (2, 3), (9, 7), (37, 21)):
        planes = [rng.integers(0, 256, (h, w)).astype(np.uint8)
                  for _ in factors]
        raw, _ = write_jpeg(planes, factors, [rng.integers(1, 30, 64)],
                            app=adobe(2) if layout == "ycck" else JFIF)
        d = image_formats.read_jpeg(raw)
        coefs = [torch.from_numpy(c) for c in d.coefficients]
        tables = [torch.from_numpy(q) for q in d.qtables]
        want = [exact_decode.idct_islow_reference(c, q)
                for c, q in zip(coefs, tables)]
        got = exact_decode.exact_idct_cuda([c.to(device) for c in coefs],
                                           [q.to(device) for q in tables])
        for g, p in zip(got, want):
            assert torch.equal(g.cpu(), p)
        for size, fraction in ((32, 0.875), (8, 1.0)):
            plan = exact_decode.resample_plan(w, h, size, fraction)
            image = exact_decode.Planes(got, d.components, d.color_space, w,
                                        h)
            out = exact_decode.color_resample_cuda(
                exact_decode.color_resample_batch([image], [plan]))
            plain = exact_decode.color_resample_reference(
                [exact_decode.Planes(want, *image[1:])], [plan])
            assert torch.equal(out.cpu(), plain)


def test_kernel_g_equals_its_plain_version(device):
    """``color_resample`` on RGB8 images (a PNG's or BMP's): Pillow's
    resize alone."""
    rng = np.random.default_rng(3)
    for w, h in ((1, 1), (5, 3), (97, 64), (640, 480), (1000, 333)):
        rgb = torch.from_numpy(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8))
        for size, fraction in ((32, 0.875), (224, 0.875), (64, 1.0)):
            plan = exact_decode.resample_plan(w, h, size, fraction)
            got = exact_decode.color_resample_cuda(
                exact_decode.color_resample_batch([rgb.to(device)], [plan]))
            assert torch.equal(got[0].cpu(),
                               exact_decode.pil_resample_reference(rgb, plan))


def _planes(w, h, factors, space, rng, device):
    """Random planes of a ``w`` x ``h`` frame's components, padded to
    whole blocks, on the card."""
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    comps = [exact_decode.Component(a, b, -(-w * a // mh), -(-h * b // mv),
                                    mh, mv) for a, b in factors]
    planes = [torch.from_numpy(rng.integers(
        0, 256, (-(-c.height // 8) * 8, -(-c.width // 8) * 8),
        dtype=np.uint8)).to(device) for c in comps]
    return exact_decode.Planes(planes, comps, space, w, h)


def test_a_mixed_chunk_equals_the_one_by_one_results(device):
    """One launch over JPEG planes of every layout and colour space and
    RGB8 images of other sizes equals each image's launch alone and the
    plain composition; a list of files decodes in chunks, one
    ``color_resample`` launch a chunk and E a JPEG."""
    rng = np.random.default_rng(5)
    images = []
    for i, layout in enumerate(LAYOUTS_WRITTEN):
        space = {"grey": exact_decode.GREY,
                 "ycck": exact_decode.YCCK}.get(layout, exact_decode.YCBCR)
        images.append(_planes(40 + 13 * i, 31 + 7 * i,
                              LAYOUTS_WRITTEN[layout], space, rng, device))
    images.append(_planes(77, 53, [(1, 1)] * 4, exact_decode.CMYK, rng,
                          device))
    for w, h in ((19, 300), (333, 250)):
        images.append(torch.from_numpy(rng.integers(
            0, 256, (h, w, 3), dtype=np.uint8)).to(device))
    plans = [exact_decode.resample_plan(
        *((i.width, i.height) if isinstance(i, exact_decode.Planes)
          else (i.shape[1], i.shape[0])), 24, 0.875) for i in images]
    chunk = exact_decode.color_resample_cuda(
        exact_decode.color_resample_batch(images, plans))
    alone = torch.cat([exact_decode.color_resample_cuda(
        exact_decode.color_resample_batch([i], [p]))
        for i, p in zip(images, plans)])
    assert torch.equal(chunk, alone)
    assert torch.equal(chunk, exact_decode.color_resample_reference(
        images, plans))
    names = [f"{n}.jpg" for n in LAYOUTS] + list(FORMAT_LAYOUTS)
    paths = [os.path.join(FIXTURES if n.endswith(".jpg") and n[:-4] in
                          LAYOUTS else FORMAT_FIXTURES, n) for n in names]
    paths = paths * (EXACT_CHUNK // len(paths) + 1)  # past one chunk
    counts = exact_decode.exact_decode_cuda.launches
    before = dict(counts)
    got = decode_image_files(paths, 224, 0.875, "exact", 4,
                             device.index or 0)
    want = np.stack([decode_image(open(p, "rb").read(), 224, 0.875, "exact",
                                  -1) for p in paths[:len(names)]])
    np.testing.assert_array_equal(got, np.concatenate(
        [want] * (len(paths) // len(names))))
    assert {k: counts[k] - before[k] for k in counts} == {
        "exact_idct": sum(p.endswith(".jpg") for p in paths),
        "color_resample": -(-len(paths) // EXACT_CHUNK)}


@pytest.mark.parametrize("w,h,layout,side", [
    (4032, 3024, "420", 4), (2000, 1500, "rgb8", 16),
    (13377, 13377, "420", 1)])
def test_a_large_image_whose_tile_shrinks_is_exact(device, w, h, layout,
                                                   side):
    """Images far larger than the crop: the plan's tiles shrink (and at
    the largest image the decoder accepts, one-pixel tiles colour their
    rectangles in strips); the kernel's bits stay the plain version's."""
    rng = np.random.default_rng(w)
    if layout == "rgb8":
        image = torch.from_numpy(rng.integers(
            0, 256, (h, w, 3), dtype=np.uint8)).to(device)
        comps = None
    else:
        image = _planes(w, h, LAYOUTS_WRITTEN[layout], exact_decode.YCBCR,
                        rng, device)
        comps = tuple(image.components)
    plan = exact_decode.resample_plan(w, h, 224, 0.875)
    tiles = exact_decode.tile_plan(plan, comps)
    assert tiles.side == side
    got = exact_decode.color_resample_cuda(
        exact_decode.color_resample_batch([image], [plan]))
    assert torch.equal(got, exact_decode.color_resample_reference(
        [image], [plan]))


def test_the_fixtures_decode_to_pils_pixels_on_the_card(device):
    counts = exact_decode.exact_decode_cuda.launches
    before = dict(counts)
    images = jpegs = 0
    for directory, names, npz in (
            (FIXTURES, [f"{n}.jpg" for n in LAYOUTS], "expected.npz"),
            (FORMAT_FIXTURES, list(FORMAT_LAYOUTS), "expected_formats.npz")):
        expected = load_expected(os.path.join(directory, npz))
        for name in names:
            with open(os.path.join(directory, name), "rb") as fd:
                got = decode_image(fd.read(), 224, 0.875, "exact",
                                   device.index or 0)
            key = name if npz == "expected_formats.npz" else name[:-4]
            np.testing.assert_array_equal(got, expected[key], err_msg=name)
            images += 1
            jpegs += name.endswith(".jpg")
    assert {k: counts[k] - before[k] for k in counts} == {
        "exact_idct": jpegs, "color_resample": images}
