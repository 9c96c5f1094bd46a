"""``color_resample``'s plan and its chunked decode, on the CPU.

The kernel (``csrc/exact_color_resample.cu``: kernels F and G of the first
design in one launch over a batch of images, a block an output tile) runs
only on a card (``tests/test_torch_exact_cuda.py``). Here: its plan
(``ops/exact_decode.py::tile_plan``) covers every tap of every output
pixel and every sample the upsampling reads, within the shared-memory
budget, for COCO's sizes, odd sizes, upscaling, a side already at its
target and the largest image the decoder accepts; the plain versions run
tile by tile and strip by strip on the plan's rectangles and windows alone
(every sample outside them poisoned) give the whole image's bits for every
upsampling method and colour space and an RGB8 source; the fields the
kernel reads are the plan's; and ``decode_image_files``' chunks keep the
input order, the bits of one-by-one decodes, and the first failure in
input order."""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dl_vqa_tpu_torch.data import image_formats, images
from dl_vqa_tpu_torch.data.images import (
    UnsupportedImage, decode_image, decode_image_files)
from dl_vqa_tpu_torch.ops import exact_decode as X

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jpeg_writer import write_jpeg  # noqa: E402

CSRC = os.path.join(os.path.dirname(X.__file__), os.pardir, "csrc")
T = {name: getattr(X, f"_T_{name}") for name in (
    "IMAGE", "OX", "OY", "TW", "TH", "X0", "Y0", "RW", "RH", "STRIP", "WIN",
    "PLANE", "UP", "RGB", "H", "XT", "YT", "OUT", "END")}

# name: (colour space, sampling factors a component)
LAYOUTS = {
    "full": (X.YCBCR, [(1, 1)] * 3),
    "h2v1": (X.YCBCR, [(2, 1), (1, 1), (1, 1)]),
    "h1v2": (X.YCBCR, [(1, 2), (1, 1), (1, 1)]),
    "h2v2": (X.YCBCR, [(2, 2), (1, 1), (1, 1)]),
    "replicate": (X.YCBCR, [(4, 1), (1, 1), (1, 1)]),
    "grey": (X.GREY, [(1, 1)]),
    "rgb": (X.RGB, [(1, 1)] * 3),
    "cmyk": (X.CMYK, [(1, 1)] * 4),
    "ycck": (X.YCCK, [(2, 2), (1, 1), (1, 1), (2, 2)]),
}


def components(width, height, factors):
    """libjpeg's components of a ``width`` x ``height`` frame."""
    mh = max(h for h, _ in factors)
    mv = max(v for _, v in factors)
    return tuple(X.Component(h, v, math.ceil(width * h / mh),
                             math.ceil(height * v / mv), mh, mv)
                 for h, v in factors)


def planes_of(comps, rng):
    """Random uint8 planes of ``comps``, padded to whole 8x8 blocks."""
    return [torch.from_numpy(rng.integers(
        0, 256, (8 * math.ceil(c.height / 8), 8 * math.ceil(c.width / 8)),
        dtype=np.uint8)) for c in comps]


def taps_of(plan):
    xt = plan.taps[:plan.size * (2 + plan.kx)].reshape(plan.size, -1)
    yt = plan.taps[plan.size * (2 + plan.kx):].reshape(plan.size, -1)
    return xt.astype(np.int64), yt.astype(np.int64)


def strips(tile):
    """The strips of a tile as the kernel walks them: (first row, rows)."""
    y0, rh, sh = tile[T["Y0"]], tile[T["RH"]], tile[T["STRIP"]]
    return [(ys, min(sh, y0 + rh - ys)) for ys in range(y0, y0 + rh, sh)]


def kernel_rows(c, ys, n, cap):
    """The plane rows the kernel stages for a strip (its formula)."""
    ve = c.max_v // c.v
    r0 = max(ys // ve - 1, 0)
    return r0, min(min((ys + n - 1) // ve + 1, c.height - 1) - r0 + 1, cap)


def reads(c, first, last, across):
    """The samples the upsampling of output pixels first .. last reads
    along one axis, by method (jdsample.c), clamped: (lo, hi)."""
    method = X.upsample_method(c)
    expand = c.max_h // c.h if across else c.max_v // c.v
    real = c.width if across else c.height
    fancy = method in ((X.H2V1, X.H2V2) if across else (X.H1V2, X.H2V2))
    if fancy:
        lo, hi = (first >> 1) - 1, (last >> 1) + 1
    elif method == X.REPLICATE:
        lo, hi = first // expand, last // expand
    else:
        lo, hi = first, last
    return (np.clip(lo, 0, real - 1), np.clip(hi, 0, real - 1))


def check_plan(plan, comps, tp, target=X.SMEM_TARGET):
    """Every claim of a tile plan, vectorized over its tiles."""
    t = tp.tiles.astype(np.int64)
    size = plan.size
    xt, yt = taps_of(plan)
    # The tiles cover the crop once, in row-major order.
    covered = np.zeros((size, size), dtype=np.int64)
    for ox, oy, tw, th in t[:, [T["OX"], T["OY"], T["TW"], T["TH"]]]:
        covered[oy:oy + th, ox:ox + tw] += 1
    assert (covered == 1).all()
    assert (t[:, T["IMAGE"]] == 0).all() and tp.side in X.TILE_SIDES
    # Each tile's rectangle holds every tap of its pixels, inside the image.
    for o, e, f, r, taps, real in (("OX", "TW", "X0", "RW", xt, plan.in_w),
                                   ("OY", "TH", "Y0", "RH", yt, plan.in_h)):
        at = np.repeat(np.arange(len(t)), t[:, T[e]])
        pixel = np.concatenate([np.arange(a, a + n)
                                for a, n in t[:, [T[o], T[e]]]])
        first, count = taps[pixel, 0], taps[pixel, 1]
        assert (count >= 1).all()
        assert (first >= t[at, T[f]]).all()
        assert (first + count <= t[at, T[f]] + t[at, T[r]]).all()
        assert (t[:, T[f]] >= 0).all()
        assert (t[:, T[f]] + t[:, T[r]] <= real).all()
    # Each component's window holds what the rectangle's upsampling reads,
    # by 8-byte columns inside the plane's padded pitch, and each strip's
    # rows as the kernel stages them.
    x0, rw = t[:, T["X0"]], t[:, T["RW"]]
    for k, c in enumerate(comps or ()):
        c0, ww = t[:, T["WIN"] + 3 * k], t[:, T["WIN"] + 3 * k + 1]
        lo, hi = reads(c, x0, x0 + rw - 1, True)
        assert (c0 % 8 == 0).all() and (ww % 8 == 0).all()
        assert (c0 <= lo).all() and (hi < c0 + ww).all()
        assert (c0 + ww <= 8 * math.ceil(c.width / 8)).all()
        for tile in t[::max(1, len(t) // 64)]:
            for ys, n in strips(tile):
                r0, rows = kernel_rows(c, ys, n, int(tile[T["WIN"] + 3 * k
                                                          + 2]))
                lo, hi = reads(c, ys, ys + n - 1, False)
                assert r0 <= lo and hi < r0 + rows, (k, tile, ys, n)
    # Shared memory: each region 16-byte aligned, in order, none
    # overlapping, every one within the tile's bytes and the budget.
    regions = ([("PLANE", k, (t[:, T["WIN"] + 3 * k + 2]
                              * t[:, T["WIN"] + 3 * k + 1]))
                for k in range(len(comps or ()))]
               + [("UP", k, t[:, T["STRIP"]] * rw
                   * (X.upsample_method(c) != X.FULL))
                  for k, c in enumerate(comps or ())]
               + [("RGB", 0, t[:, T["STRIP"]] * rw * 4),
                  ("H", 0, t[:, T["RH"]] * t[:, T["TW"]] * 4),
                  ("XT", 0, t[:, T["TW"]] * (2 + plan.kx) * 4),
                  ("YT", 0, t[:, T["TH"]] * (2 + plan.ky) * 4),
                  ("OUT", 0, t[:, T["TH"]] * t[:, T["TW"]] * 3)])
    end = np.zeros(len(t), dtype=np.int64)
    for name, k, nbytes in regions:
        start = t[:, T[name] + k]
        assert (start % 16 == 0).all() and (start >= end).all()
        end = start + nbytes
    assert (end <= t[:, T["END"]]).all()
    assert tp.smem == t[:, T["END"]].max() <= X.SMEM_LIMIT
    if tp.side > 1 or (t[:, T["STRIP"]] == t[:, T["RH"]]).all():
        assert tp.smem <= target
    assert (t[:, T["STRIP"]] >= 1).all()


MAX_SIDE = math.isqrt(image_formats.MAX_PIXELS)


@pytest.mark.parametrize("width,height,layout", [
    (640, 480, "h2v2"), (480, 640, "h2v2"), (333, 257, "h2v1"),
    (201, 97, "ycck"), (100, 75, "full"), (256, 300, "h1v2"),
    (300, 256, "rgb8"), (MAX_SIDE, MAX_SIDE, "h2v2"),
    (MAX_SIDE, MAX_SIDE, "cmyk")])
def test_every_tile_covers_its_taps_within_the_budget(width, height, layout):
    """The decoder's plans (224 px at 0.875): COCO's 640x480 and 480x640,
    odd sizes, an image smaller than the resize (upscaling), a side already
    at its target of 256 (identity taps), an RGB8 source, and the largest
    image the decoder accepts (plan only: strips of one-pixel tiles)."""
    plan = X.resample_plan(width, height, 224, 0.875)
    comps = (None if layout == "rgb8"
             else components(width, height, LAYOUTS[layout][1]))
    tp = X.tile_plan(plan, comps)
    check_plan(plan, comps, tp)
    if (width, height) == (640, 480):
        assert tp.side == 32 and len(tp.tiles) == 49
    if width == MAX_SIDE:
        assert tp.side == 1
        assert (tp.tiles[:, T["STRIP"]] < tp.tiles[:, T["RH"]]).any()


def poisoned(plane, r0, rows, c0, ww):
    """``plane`` with every sample outside the window changed by 128."""
    out = plane ^ 0x80
    out[r0:r0 + rows, c0:c0 + ww] = plane[r0:r0 + rows, c0:c0 + ww]
    return out


def by_tiles(image, plan, tp):
    """The plain versions run as the kernel runs them: tile by tile, strip
    by strip, reading only the plan's windows (a JPEG's) or rectangle (an
    RGB8 source's) -> uint8 ``[S, S, 3]``."""
    xt, yt = taps_of(plan)
    xt, yt = torch.from_numpy(xt), torch.from_numpy(yt)
    out = torch.zeros(plan.size, plan.size, 3, dtype=torch.uint8)
    for tile in tp.tiles.astype(np.int64).tolist():
        ox, oy, tw, th = (tile[T[k]] for k in ("OX", "OY", "TW", "TH"))
        x0, y0, rw, rh = (tile[T[k]] for k in ("X0", "Y0", "RW", "RH"))
        hpass = []
        cols = xt[ox:ox + tw]
        for ys, n in strips(tile):
            if isinstance(image, X.Planes):
                masked = []
                for k, (p, c) in enumerate(zip(image.planes,
                                               image.components)):
                    r0, rows = kernel_rows(c, ys, n, tile[T["WIN"] + 3 * k
                                                          + 2])
                    masked.append(poisoned(p, r0, rows, tile[T["WIN"] + 3 * k],
                                           tile[T["WIN"] + 3 * k + 1]))
                rgb = X._color(masked, image.components, image.color_space,
                               torch.arange(x0, x0 + rw),
                               torch.arange(ys, ys + n))
            else:
                rgb = image[ys:ys + n, x0:x0 + rw]
            across = X._pass(rgb.to(torch.int64).transpose(0, 1),
                             cols[:, 0] - x0, cols[:, 1], cols[:, 2:], rw)
            hpass.append(across.transpose(0, 1))
        rows = yt[oy:oy + th]
        out[oy:oy + th, ox:ox + tw] = X._pass(
            torch.cat(hpass), rows[:, 0] - y0, rows[:, 1], rows[:, 2:],
            rh).to(torch.uint8)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS) + ["rgb8"])
def test_tile_by_tile_equals_the_whole(layout):
    """The plain composition on the plan's rectangles and windows alone
    equals :func:`color_resample_reference` of the whole image, to the bit,
    at the decoder's budget (one tile here), at budgets that make the plan
    shrink its tiles, and at one that cuts one-pixel tiles into strips;
    downscaled and upscaled."""
    rng = np.random.default_rng(sorted(LAYOUTS).index(layout)
                                if layout in LAYOUTS else 99)
    for width, height in ((37, 29), (9, 11)):
        if layout == "rgb8":
            comps = None
            image = torch.from_numpy(rng.integers(
                0, 256, (height, width, 3), dtype=np.uint8))
        else:
            space, factors = LAYOUTS[layout]
            comps = components(width, height, factors)
            image = X.Planes(planes_of(comps, rng), comps, space, width,
                             height)
        plan = X.resample_plan(width, height, 12, 0.875)
        want = X.color_resample_reference([image], [plan])[0]
        sides = set()
        for target in (X.SMEM_TARGET, 1200, 700, 300):
            tp = X.tile_plan(plan, comps, target)
            check_plan(plan, comps, tp, target)
            sides.add((tp.side, int(tp.tiles[:, T["STRIP"]].min())))
            assert torch.equal(by_tiles(image, plan, tp), want), (
                layout, width, height, target)
        assert len(sides) >= 3, sides


def test_the_kernel_reads_the_plans_fields():
    """``csrc/exact_color_resample.cu``'s TileField and ImageField are the
    plan's fields in the plan's order, and its shared-memory limit is
    ``SMEM_LIMIT``."""
    with open(os.path.join(CSRC, "exact_color_resample.cu")) as fd:
        src = re.sub(r"//[^\n]*", "", fd.read())

    def enum(name):
        body = re.search(rf"enum {name} \{{(.*?)\}};", src, re.S).group(1)
        out, at = {}, 0
        for item in (i.strip() for i in body.split(",") if i.strip()):
            key, _, expr = (x.strip() for x in item.partition("="))
            if expr:
                at = eval(expr, {}, {"kMaxComponents": 4, **out})
            out[key] = at
            at += 1
        return out

    tile = enum("TileField")
    assert tile["kTileFields"] == X.TILE_FIELDS
    assert [tile[f"t{n}"] for n in (
        "Image", "Ox", "Oy", "Tw", "Th", "X0", "Y0", "Rw", "Rh", "Strip",
        "Win", "OffPlane", "OffUp", "OffRgb", "OffH", "OffXt", "OffYt",
        "OffOut", "End")] == [T[n] for n in (
            "IMAGE", "OX", "OY", "TW", "TH", "X0", "Y0", "RW", "RH", "STRIP",
            "WIN", "PLANE", "UP", "RGB", "H", "XT", "YT", "OUT", "END")]
    image = enum("ImageField")
    assert image["kPlanes"] == 10
    assert re.search(r"kImageFields = kPlanes \+ kMaxComponents \* "
                     r"kPlaneFields;", src)
    assert "constexpr int kPlaneFields = 7;" in src
    assert 10 + 4 * 7 == X.IMAGE_FIELDS
    limit = re.search(r"kMaxDynamic = ([0-9 \-]+);", src).group(1)
    assert eval(limit) == X.SMEM_LIMIT


def _files(tmp_path, n, bad=()):
    """``n`` small image files, JPEGs of several layouts, PNGs and BMPs,
    with the indices in ``bad`` truncated JPEGs."""
    rng = np.random.default_rng(7)
    paths = []
    for i in range(n):
        w, h = 20 + (i % 5), 17 + (i % 3)
        path = tmp_path / f"f{i:02d}"
        if i in bad:
            raw, _ = write_jpeg([rng.integers(0, 256, (h, w)).astype(
                np.uint8)], [(1, 1)], [rng.integers(1, 30, 64)])
            path.write_bytes(raw[:len(raw) // 2])
        elif i % 4 == 3:
            fmt = "PNG" if i % 8 == 3 else "BMP"
            Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
                np.uint8)).save(path, fmt)
        else:
            factors = [[(2, 2), (1, 1), (1, 1)], [(1, 1)] * 3,
                       [(1, 1)]][i % 4 % 3]
            raw, _ = write_jpeg(
                [rng.integers(0, 256, (h, w)).astype(np.uint8)
                 for _ in factors], factors, [rng.integers(1, 30, 64)])
            path.write_bytes(raw)
        paths.append(str(path))
    return paths


def test_chunks_keep_the_order_the_bits_and_the_first_failure(
        tmp_path, monkeypatch):
    """``decode_image_files``' exact decode in chunks of ``EXACT_CHUNK``
    (4 here) over 11 files (not a multiple of it) equals the one-by-one
    decodes, on 1 and 3 threads, and so it does with each chunk cut into
    device calls of at most ``EXACT_CHUNK_BYTES``; a bad file in the
    second chunk raises naming itself, the first failure in input order,
    and so does the first of two."""
    monkeypatch.setattr(images, "EXACT_CHUNK", 4)
    paths = _files(tmp_path, 11)
    want = np.stack([decode_image(open(p, "rb").read(), 12, 0.875, "exact",
                                  -1) for p in paths])
    for threads in (1, 3):
        np.testing.assert_array_equal(
            decode_image_files(paths, 12, 0.875, "exact", threads, -1), want)
    sources = [images._exact_source(open(p, "rb").read(), 12, 0.875, p)
               for p in paths[:4]]
    monkeypatch.setattr(images, "EXACT_CHUNK_BYTES", 4000)
    calls = images._calls(sources)
    # Inputs of 3,072, 3,456, 1,152 and 1,173 B.
    assert [len(c) for c in calls] == [1, 1, 2]
    assert [pair for c in calls for pair in c] == sources
    images._close(source for source, _ in sources)
    np.testing.assert_array_equal(
        decode_image_files(paths, 12, 0.875, "exact", 3, -1), want)
    bad = _files(tmp_path, 11, bad=(5, 9))
    for threads in (1, 3):
        with pytest.raises(UnsupportedImage, match="f05"):
            decode_image_files(bad, 12, 0.875, "exact", threads, -1)
        with pytest.raises(UnsupportedImage, match="f09"):
            decode_image_files(bad[6:], 12, 0.875, "exact", threads, -1)


class _HostStaging:
    """A staging whose "card" buffer is host memory, for reading the chunk
    call's descriptors as the C entry reads them."""

    def __init__(self):
        self.host = self.dev = self.out = None
        self.stream = type("Stream", (), {"cuda_stream": 0})()

    def reserve(self, in_bytes, dev_bytes, out_bytes):
        self.host = torch.zeros(in_bytes, dtype=torch.uint8)
        self.dev = torch.zeros(dev_bytes, dtype=torch.uint8)
        self.out = torch.zeros(out_bytes, dtype=torch.uint8)


def _at(address, ctype, n):
    return np.ctypeslib.as_array((ctype * int(n)).from_address(int(address)))


class _PipelineOnHost:
    """``vqa_exact_decode_batch`` (``csrc/exact_pipeline.cu``) run on the
    host from its descriptor alone: the copy in, kernel E's plain version
    at each JPEG's pointers, ``color_resample`` tile by tile from the
    images' descriptors and tiles it points at, the copy out."""

    def vqa_exact_decode_batch(self, desc_address, stream):
        import ctypes

        d = _at(desc_address, ctypes.c_int64, 11)
        ctypes.memmove(int(d[1]), int(d[0]), int(d[2]))
        entries = _at(desc_address, ctypes.c_int64, 11 + 21 * d[10])[11:]
        for e in entries.reshape(-1, 21):
            for c in range(e[0]):
                coef, table, plane, bw, bh = e[1 + 5 * c:6 + 5 * c]
                got = X.idct_islow_reference(
                    torch.from_numpy(_at(coef, ctypes.c_int16,
                                         bh * bw * 64).reshape(bh, bw, 64)),
                    torch.from_numpy(_at(table, ctypes.c_int16, 64)))
                _at(plane, ctypes.c_uint8, got.numel())[:] = got.reshape(
                    -1).numpy()
        tiles = _at(d[7], ctypes.c_int32, d[8] * X.TILE_FIELDS).reshape(
            -1, X.TILE_FIELDS)
        assert tiles[:, T["END"]].max() == d[9]
        n = int(tiles[:, 0].max()) + 1
        rows = _at(d[6], ctypes.c_int64, n * X.IMAGE_FIELDS).reshape(
            n, X.IMAGE_FIELDS)
        for i, row in enumerate(rows):
            out, taps, rgb, kx, ky, size, ncomp, space, w, h = (
                int(v) for v in row[:10])
            plan = X.ResamplePlan(w, h, size, kx, ky, _at(
                taps, ctypes.c_int32, size * (4 + kx + ky)).copy())
            if ncomp:
                planes, comps = [], []
                for k in range(ncomp):
                    ptr, pitch, cw, ch, he, ve, method = (
                        int(v) for v in row[10 + 7 * k:17 + 7 * k])
                    comp = X.Component(1, 1, cw, ch, he, ve)
                    assert X.upsample_method(comp) == method
                    comps.append(comp)
                    planes.append(torch.from_numpy(_at(
                        ptr, ctypes.c_uint8, ch * pitch).reshape(ch, pitch)))
                image = X.Planes(planes, comps, space, w, h)
            else:
                image = torch.from_numpy(_at(rgb, ctypes.c_uint8,
                                             h * w * 3).reshape(h, w, 3))
            mine = tiles[tiles[:, 0] == i]
            got = by_tiles(image, plan, X.TilePlan(0, mine, int(d[9])))
            _at(out, ctypes.c_uint8, got.numel())[:] = got.reshape(-1).numpy()
        ctypes.memmove(int(d[3]), int(d[4]), int(d[5]))
        return 0


def test_the_chunk_call_reads_its_inputs_where_the_descriptors_say(
        tmp_path, monkeypatch):
    """``exact_decode_cuda``'s one call for a mixed chunk (JPEGs of two
    sizes and layouts, a PNG, a BMP, one JPEG twice), read from its
    descriptor as the C entry reads it (the copies, E at each JPEG's
    pointers, ``color_resample`` from the images' descriptors and tiles),
    gives the plain versions' bits, and counts E a JPEG and one
    ``color_resample``."""
    from dl_vqa_tpu_torch.ops import _native

    paths = _files(tmp_path, 8)
    paths.append(paths[0])
    sources, plans = [], []
    for path in paths:
        source, plan = images._exact_source(open(path, "rb").read(), 12,
                                            0.875, path)
        sources.append(source)
        plans.append(plan)
    monkeypatch.setattr(_native, "library", lambda: _PipelineOnHost())
    monkeypatch.setattr(X.exact_decode_cuda, "launches",
                        {"exact_idct": 0, "color_resample": 0})
    got = X.exact_decode_cuda(sources, plans, _HostStaging())
    np.testing.assert_array_equal(
        got, X.decode_batch(sources, plans, torch.device("cpu")))
    jpegs = sum(hasattr(s, "export") for s in sources)
    assert X.exact_decode_cuda.launches == {"exact_idct": jpegs,
                                            "color_resample": 1}
    images._close(sources)
