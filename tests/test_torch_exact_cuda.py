"""Kernels E, F and G of the exact decoder against their plain versions,
on the card, to the bit: every sampling layout and colour space of small
JPEGs written by ``tests/jpeg_writer.py``, resizes down and up, and the
whole decode of the committed fixtures. Every test here needs a GPU and
skips without one. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_exact_cuda.py -q
"""

import os
import sys

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.data import image_formats
from dl_vqa_tpu_torch.data.images import decode_image
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
        rgb = exact_decode.exact_color_cuda(got, d.components,
                                            d.color_space, w, h)
        assert torch.equal(rgb.cpu(), exact_decode.upsample_color_reference(
            want, d.components, d.color_space, w, h))


def test_kernel_g_equals_its_plain_version(device):
    rng = np.random.default_rng(3)
    for w, h in ((1, 1), (5, 3), (97, 64), (640, 480), (1000, 333)):
        rgb = torch.from_numpy(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8))
        for size, fraction in ((32, 0.875), (224, 0.875), (64, 1.0)):
            plan = exact_decode.resample_plan(w, h, size, fraction)
            got = exact_decode.pil_resample_cuda(rgb.to(device), plan)
            assert torch.equal(got.cpu(), exact_decode.pil_resample_reference(
                rgb, plan))


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
        "exact_idct": jpegs, "exact_color": jpegs, "pil_resample": images}
