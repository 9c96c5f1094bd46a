"""The exact decoder's JPEG path and its resize against PIL, to the bit.

The entropy decoder (``csrc/host/jpeg_entropy.cc``) against the
coefficients it was given (``tests/jpeg_writer.py``, and PIL's progressive
files against PIL's baseline files of the same image); the plain versions
of kernels E, F and G (``ops/exact_decode.py``) and the whole ``"exact"``
decode against PIL 12.1's decode, ``convert("RGB")`` and reference
transform on images made from a numpy seed: baseline 4:4:4, 4:2:2, 4:2:0
and the layouts PIL's encoder does not write (4:4:0, 4:1:1, 3:1, chroma
planes at most 2 samples wide), progressive, restart intervals,
greyscale, RGB by component ids, CMYK and YCCK (Adobe), odd sizes down to
1x1 and upscaling; the refusals; and the JAX package: its
``preprocess_pil_image`` and the committed transform golden."""

import io
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dl_vqa_tpu.data.images import preprocess_pil_image
from dl_vqa_tpu_torch.data import image_formats
from dl_vqa_tpu_torch.data.images import (
    UnsupportedImage, decode_image, decode_image_files, normalize_uint8_chw)
from dl_vqa_tpu_torch.ops import exact_decode
from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
    FIXTURES, LAYOUTS, load_expected)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jpeg_writer import JFIF, adobe, write_jpeg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(w, h, n, seed):
    """``n`` smooth-with-noise uint8 planes ``[h, w]``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        img = (128 + 70 * np.sin(x / rng.uniform(2, 6) + rng.uniform(0, 6))
               + 50 * np.cos(y / rng.uniform(2, 5)) + rng.normal(0, 15,
                                                                  (h, w)))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _quant(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 48, 64) for _ in range(n)]


def _rgb(raw):
    """The exact decoder's plain versions up to ``convert("RGB")``."""
    d = image_formats.read_jpeg(raw)
    planes = [exact_decode.idct_islow_reference(torch.from_numpy(c),
                                                torch.from_numpy(q))
              for c, q in zip(d.coefficients, d.qtables)]
    return d, exact_decode.upsample_color_reference(
        planes, d.components, d.color_space, d.width, d.height).numpy()


def _pil_rgb(raw):
    with Image.open(io.BytesIO(raw)) as img:
        return np.asarray(img.convert("RGB"))


def _pil_transform(img, size, fraction):
    """PIL's reference transform before the normalization (uint8)."""
    img = img.convert("RGB")
    target = int(size / fraction)
    w, h = img.size
    shape = (target, int(target * h / w)) if w <= h else (
        int(target * w / h), target)
    img = img.resize(shape, Image.BILINEAR)
    w, h = img.size
    left, top = int(round((w - size) / 2.0)), int(round((h - size) / 2.0))
    return np.asarray(img.crop((left, top, left + size, top + size)))


SIZES = [(1, 1), (2, 3), (9, 7), (17, 33), (40, 24)]
FACTORS = {
    "444": [(1, 1), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)],
    "440": [(1, 2), (1, 1), (1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "31": [(3, 1), (1, 1), (1, 1)],
    "luma_low": [(1, 1), (2, 2), (1, 1)],
    "grey_2x2": [(2, 2)],
}


@pytest.mark.parametrize("layout", list(FACTORS))
def test_written_jpegs_give_their_coefficients_and_pils_pixels(layout):
    """Every sampling layout at odd sizes down to 1x1 (chroma planes of 1
    and 2 samples, where libjpeg replicates), with and without a restart
    interval, a JFIF marker or RGB component ids, 16-bit tables and the
    standard Huffman tables left out: the entropy decoder gives the
    written coefficients, kernels E and F PIL's pixels."""
    factors = FACTORS[layout]
    for k, (w, h) in enumerate(SIZES):
        for restart, app, ids, dqt16, std in (
                (0, JFIF, None, False, False),
                (2, b"", [82, 71, 66], True, True)):
            if len(factors) == 1 and ids:
                ids = None
            quant = _quant(k + 10 * restart)
            if dqt16:
                quant = [q * 5 for q in quant]
            raw, coefs = write_jpeg(_planes(w, h, len(factors), k), factors,
                                    quant, restart=restart, ids=ids, app=app,
                                    dqt16=dqt16, std_tables=std)
            d, got = _rgb(raw)
            for mine, written in zip(d.coefficients, coefs):
                np.testing.assert_array_equal(mine, written)
            want = _pil_rgb(raw)
            np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} "
                                          f"restart {restart} ids {ids}")


@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK"])
@pytest.mark.parametrize("options", [
    {"quality": 90, "subsampling": 0},
    {"quality": 75, "subsampling": 1},
    {"quality": 60, "subsampling": 2, "optimize": True},
    {"quality": 80, "subsampling": 2, "progressive": True},
    {"quality": 95, "subsampling": 0, "progressive": True},
    {"quality": 85, "subsampling": 1, "restart_marker_blocks": 2},
    {"quality": 70, "subsampling": 2, "restart_marker_rows": 1},
], ids=["444", "422", "420_optimized", "420_progressive",
        "444_progressive", "422_restart_blocks", "420_restart_rows"])
def test_pil_written_jpegs_decode_to_pils_pixels(mode, options):
    """PIL's own JPEGs of an image made from a seed, odd sizes included:
    the exact decode to ``convert("RGB")`` equals PIL's; a progressive
    file (several AC refinement scans) gives the coefficients of the
    baseline file PIL writes with the same options."""
    rng = np.random.default_rng(len(mode))
    for w, h in ((1, 1), (7, 5), (33, 17), (64, 48)):
        base = rng.integers(0, 256, (h, w, 3)).astype(np.float64)
        img = np.clip(base * 0.4 + 110 + 60 * np.sin(
            np.arange(w) / 3.0)[None, :, None], 0, 255).astype(np.uint8)
        im = Image.fromarray(img).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "JPEG", **options)
        raw = buf.getvalue()
        d, got = _rgb(raw)
        np.testing.assert_array_equal(got, _pil_rgb(raw), err_msg=f"{w}x{h}")
        if options.get("progressive"):
            baseline = dict(options, progressive=False)
            buf = io.BytesIO()
            im.save(buf, "JPEG", **baseline)
            want = image_formats.read_jpeg(buf.getvalue())
            for mine, theirs in zip(d.coefficients, want.coefficients):
                np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("transform,ncomp", [(0, 4), (2, 4), (1, 3), (2, 3),
                                             (None, 4)])
def test_adobe_colour_spaces_as_libjpeg_infers_them(transform, ncomp):
    """Four components: Adobe transform 0 CMYK, 2 YCCK (libjpeg converts
    it to CMYK), no marker CMYK, each inverted and converted as PIL's
    ``CMYK;I`` and ``cmyk2rgb``; three: transform 1 or 2 YCbCr."""
    factors = [(2, 2), (1, 1), (1, 1), (2, 2)][:ncomp]
    app = b"" if transform is None else adobe(transform)
    raw, _ = write_jpeg(_planes(21, 13, ncomp, 3), factors, _quant(3),
                        app=app)
    d, got = _rgb(raw)
    want_space = {(0, 4): exact_decode.CMYK, (2, 4): exact_decode.YCCK,
                  (None, 4): exact_decode.CMYK}.get((transform, ncomp),
                                                    exact_decode.YCBCR)
    assert d.color_space == want_space
    np.testing.assert_array_equal(got, _pil_rgb(raw))


def test_the_inverse_dct_clamps_as_pils_libjpeg_turbo():
    """A block pushed past the range limit's +-384 (random samples coded
    with a table of 1, then read with a table of 8): PIL's pixels follow a
    clamp, where libjpeg's C table (``x & 1023``) would wrap; kernel E's
    plain version gives PIL's bits."""
    plane = np.random.default_rng(2).integers(0, 256, (32, 32)).astype(
        np.uint8)
    raw, _ = write_jpeg([plane], [(1, 1)], [np.ones(64, int)], app=JFIF)
    raw = bytearray(raw)
    at = raw.index(b"\xff\xdb")
    raw[at + 5:at + 5 + 64] = bytes([8] * 64)
    raw = bytes(raw)
    d = image_formats.read_jpeg(raw)
    coef = torch.from_numpy(d.coefficients[0])
    got = exact_decode.idct_islow_reference(
        coef, torch.from_numpy(d.qtables[0]))[:32, :32].numpy()
    with Image.open(io.BytesIO(raw)) as img:
        want = np.asarray(img.convert("L"))
    np.testing.assert_array_equal(got, want)
    assert int(coef.abs().max()) * 8 > 384  # past the table's +-384


def _truncate(raw):
    """``raw`` cut in the middle of its (last) scan's data."""
    sos = raw.rindex(b"\xff\xda")
    start = sos + 2 + int.from_bytes(raw[sos + 2:sos + 4], "big")
    return raw[:start + (len(raw) - start) // 2]


def _patch(raw, old, new):
    at = raw.index(old)
    return raw[:at] + new + raw[at + len(old):]


@pytest.mark.parametrize("case,what", [
    ("sof3", "a lossless JPEG (SOF3)"),
    ("sof9", "an arithmetic-coded JPEG (SOF9)"),
    ("sof5", "a hierarchical JPEG (SOF5)"),
    ("12bit", "a 12-bit JPEG"),
    ("dnl", "a JPEG with a DNL marker"),
    ("truncated", "a truncated scan"),
    ("two_components", "a JPEG of 2 components"),
    ("fractional", "not integral"),
])
def test_refusals_raise_unsupported_image_naming_the_variant(case, what):
    raw, _ = write_jpeg(_planes(24, 16, 3, 0), FACTORS["420"], _quant(0),
                        app=JFIF)
    sof = raw.index(b"\xff\xc0")
    if case in ("sof3", "sof9", "sof5"):
        raw = raw[:sof + 1] + bytes([0xC0 + int(case[3:])]) + raw[sof + 2:]
    elif case == "12bit":
        raw = raw[:sof + 4] + b"\x0c" + raw[sof + 5:]
    elif case == "dnl":
        raw = raw[:sof + 5] + b"\x00\x00" + raw[sof + 7:]
    elif case == "truncated":
        raw = _truncate(raw)
    elif case == "two_components":
        raw, _ = write_jpeg(_planes(8, 8, 2, 0), [(1, 1), (1, 1)],
                            _quant(0))
    elif case == "fractional":  # luma 3 across, a chroma plane 2
        raw, _ = write_jpeg(_planes(24, 16, 3, 0), FACTORS["31"], _quant(0))
        sof = raw.index(b"\xff\xc0")
        raw = raw[:sof + 14] + b"\x21" + raw[sof + 15:]
    with pytest.raises(UnsupportedImage, match=re.escape(what)):
        image_formats.read_jpeg(raw)
    with pytest.raises(UnsupportedImage, match="the image"):
        decode_image(raw, 16, 0.875, "exact", -1)


def test_a_damaged_scan_or_table_raises_value_error():
    raw, _ = write_jpeg(_planes(24, 16, 3, 1), FACTORS["420"], _quant(1),
                        app=JFIF, restart=1)
    with pytest.raises(ValueError, match="restart marker"):
        image_formats.read_jpeg(_patch(raw, b"\xff\xd0", b"\xff\xd5"))
    dht = raw.index(b"\xff\xc4")
    bad = raw[:dht + 5] + b"\x02" + raw[dht + 6:]  # 2 codes of length 1
    with pytest.raises(ValueError, match="Huffman table"):
        image_formats.read_jpeg(bad)


@pytest.mark.parametrize("size,fraction", [(32, 0.875), (64, 0.875),
                                           (24, 1.0), (224, 0.875)])
def test_plain_resample_is_pils_resize_and_crop(size, fraction):
    """Kernel G's plain version against PIL's resize and crop on RGB
    images made from a seed: downscale, upscale (a 1x1, 5x3 and 31x17
    source to 224), odd sizes, landscape and portrait."""
    rng = np.random.default_rng(size)
    for w, h in ((1, 1), (5, 3), (31, 17), (97, 64), (64, 97), (101, 83),
                 (640, 480)):
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        plan = exact_decode.resample_plan(w, h, size, fraction)
        got = exact_decode.pil_resample_reference(torch.from_numpy(rgb),
                                                  plan).numpy()
        want = _pil_transform(Image.fromarray(rgb), size, fraction)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")


def test_the_committed_golden_is_held_by_the_plain_resample():
    """``tests/fixtures/image_transform_golden.npz`` (the JAX package's
    reference transform of three RGB arrays at 32 and 64 px):
    :func:`pil_resample_reference` and ``normalize_uint8_chw`` give its
    fp16 features to the bit."""
    path = os.path.join(REPO, "tests", "fixtures",
                        "image_transform_golden.npz")
    with np.load(path) as data:
        names = [k[3:] for k in data.files if k.startswith("in_")]
        assert len(names) == 3
        for name in names:
            rgb = data[f"in_{name}"]
            for size in (32, 64):
                plan = exact_decode.resample_plan(rgb.shape[1], rgb.shape[0],
                                                  size, 0.875)
                u8 = exact_decode.pil_resample_reference(
                    torch.from_numpy(rgb), plan).numpy()
                np.testing.assert_array_equal(
                    normalize_uint8_chw(u8[None])[0].astype(np.float16),
                    data[f"out_{name}_{size}"], err_msg=f"{name} {size}")


def test_preprocess_pil_image_equals_exact_and_normalize():
    """The JAX package's ``preprocess_pil_image`` of each JPEG fixture and
    of generated JPEGs (upscaled from 9x7, odd, progressive) equals the
    exact decode then ``normalize_uint8_chw``, in f32, to the bit."""
    raws = []
    for name in LAYOUTS:
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as fd:
            raws.append(fd.read())
    for w, h, options in ((9, 7, {}), (45, 31, {"progressive": True}),
                          (30, 50, {"subsampling": 1})):
        rng = np.random.default_rng(w)
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8)).save(buf, "JPEG", **options)
        raws.append(buf.getvalue())
    for raw in raws:
        for size in (32, 224):
            with Image.open(io.BytesIO(raw)) as img:
                want = preprocess_pil_image(img, size, 0.875)
            got = normalize_uint8_chw(
                decode_image(raw, size, 0.875, "exact", -1)[None])[0]
            np.testing.assert_array_equal(got, want)


def test_the_fixtures_decode_to_pils_pixels_one_by_one_and_as_files():
    """The four JPEG fixtures (4:2:0 at 640x480, 4:2:2, grey, progressive
    4:4:4): ``decode_image`` and ``decode_image_files`` on three threads
    give ``expected.npz`` to the bit."""
    expected = load_expected()
    paths = [os.path.join(FIXTURES, f"{n}.jpg") for n in LAYOUTS]
    files = decode_image_files(paths * 2, 224, 0.875, "exact", 3, -1)
    for i, name in enumerate(list(LAYOUTS) * 2):
        np.testing.assert_array_equal(files[i], expected[name])
    with open(paths[0], "rb") as fd:
        np.testing.assert_array_equal(
            decode_image(fd.read(), 224, 0.875, "exact", -1),
            expected[list(LAYOUTS)[0]])


def test_a_list_of_files_names_the_first_that_fails(tmp_path):
    good = os.path.join(FIXTURES, f"{list(LAYOUTS)[1]}.jpg")
    bad = tmp_path / "b.jpg"
    bad.write_bytes(_truncate(open(good, "rb").read()))
    gif = tmp_path / "c.jpg"
    Image.new("RGB", (4, 4)).save(gif, "GIF")
    for threads in (1, 3):
        with pytest.raises(UnsupportedImage, match="b.jpg: a truncated"):
            decode_image_files([good, str(bad), str(gif)], 32, 0.875,
                               "exact", threads, -1)
        with pytest.raises(UnsupportedImage, match="c.jpg: a GIF"):
            decode_image_files([good, str(gif)], 32, 0.875, "exact",
                               threads, -1)
        with pytest.raises(FileNotFoundError, match="none.jpg"):
            decode_image_files([good, str(tmp_path / "none.jpg")], 32,
                               0.875, "exact", threads, -1)


def test_the_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """A decode on the CPU is the plain versions, one after the other;
    each ``*_cuda`` wrapper (``color_resample``'s through the batch it
    takes) refuses a CPU tensor, and neither they nor the card's one-call
    decode count anything."""
    raw, _ = write_jpeg(_planes(16, 16, 3, 4), FACTORS["422"], _quant(4))
    d = image_formats.read_jpeg(raw)
    coefs = [torch.from_numpy(c) for c in d.coefficients]
    tables = [torch.from_numpy(q) for q in d.qtables]
    planes = [exact_decode.idct_islow_reference(c, q)
              for c, q in zip(coefs, tables)]
    rgb = exact_decode.upsample_color_reference(planes, d.components,
                                                d.color_space, 16, 16)
    plan = exact_decode.resample_plan(16, 16, 8, 0.5)
    counts = (exact_decode.exact_idct_cuda.launches,
              exact_decode.color_resample_cuda.launches,
              dict(exact_decode.exact_decode_cuda.launches))
    got = exact_decode.decode_on_device(d, 8, 0.5, torch.device("cpu"))
    np.testing.assert_array_equal(
        got, exact_decode.pil_resample_reference(rgb, plan).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        exact_decode.exact_idct_cuda(coefs, tables)
    with pytest.raises(ValueError, match="CUDA"):
        exact_decode.color_resample_batch([exact_decode.Planes(
            planes, d.components, d.color_space, 16, 16)], [plan])
    with pytest.raises(ValueError, match="CUDA"):
        exact_decode.color_resample_batch([rgb], [plan])
    assert counts == (exact_decode.exact_idct_cuda.launches,
                      exact_decode.color_resample_cuda.launches,
                      exact_decode.exact_decode_cuda.launches)


class _FakeStaging:
    def __init__(self, device):
        self.device = device
        self.buffers = [1 << 10, 1 << 30]
        self.trimmed = []

    def trim(self, keep_bytes):
        self.trimmed.append(keep_bytes)
        self.buffers = [n for n in self.buffers if n <= keep_bytes]


def test_the_staging_pool_is_bounded_and_blocks():
    """The card's decodes share at most ``size`` stagings a device: a take
    past them waits until one is given back, and gets that one; a staging
    given back is trimmed to ``keep_bytes`` a buffer."""
    import threading

    pool = exact_decode.StagingPool(_FakeStaging, size=2, keep_bytes=1 << 20)
    first, second = pool.take("card0"), pool.take("card0")
    other = pool.take("card1")  # another device has its own stagings
    assert first is not second and pool.made == {"card0": 2, "card1": 1}
    got = []
    waiter = threading.Thread(target=lambda: got.append(pool.take("card0")))
    waiter.start()
    waiter.join(timeout=0.2)
    assert waiter.is_alive() and not got  # all of card0's are in use
    pool.give("card0", second)
    waiter.join(timeout=10)
    assert got == [second] and pool.made["card0"] == 2
    assert second.trimmed == [1 << 20] and second.buffers == [1 << 10]
    pool.give("card1", other)
    assert pool.take("card1") is other
    with pytest.raises(ValueError, match="0 stagings"):
        exact_decode.StagingPool(_FakeStaging, size=0, keep_bytes=0)
