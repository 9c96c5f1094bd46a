#!/usr/bin/env python3
"""Time the exact decoder's colour and resize stages of two designs in
turns on one card, and hold both to the plain composition's bits: the
first design's kernels F and G (``exact_color.cu``, ``pil_resample.cu``:
a launch each an image) against ``color_resample``
(``exact_color_resample.cu``: one launch a batch of images).

    python3 -m dl_vqa_tpu_torch.tools.compare_exact PARENT_DIR \\
        [--batches=1,8,64]

PARENT_DIR holds the first design's two files (``git show
<rev>:dl_vqa_tpu_torch/csrc/exact_color.cu``, likewise
``pil_resample.cu``, into a directory that ``.gitignore`` lists);
``exact_color_resample.cu`` comes from this tree's
``dl_vqa_tpu_torch/csrc``. Each is compiled by ``nvcc -Xptxas -v`` (the
tool prints each kernel's registers and spills). On N copies, each its own
tensors, of the COCO-sized 640x480 4:2:0 fixture's planes (this tree's
kernel E), for N = 1, 8 and 64 (or the batches given), it checks that both
designs give the plain composition's bits
(``ops/exact_decode.py::color_resample_reference``), then replays each
design's launches for the N images from a CUDA graph (F and G an image
against one ``color_resample``) in turns, first, second, second, first,
and prints the time of the N images, the time an image and the share of
the bound (``tools/_compare.py::color_resample_work`` at 3.35 TB/s and 67
T 32-bit operations a second). Run from the repository root on a machine
with an NVIDIA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile

import torch

from dl_vqa_tpu_torch.data import image_formats
from dl_vqa_tpu_torch.ops import _native, exact_decode as X
from dl_vqa_tpu_torch.tools._compare import (
    CSRC, build, card, color_resample_work)
from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
    FIXTURES, LOAD_FIXTURE)

BATCHES = (1, 8, 64)
HBM_BYTES_PER_S = 3.35e12
PEAK_32BIT_OPS = 67e12
ITERS = 50  # graph replays a timing
_P, _I = ctypes.c_void_p, ctypes.c_int


def load(parent: str, out_dir: str) -> tuple:
    """The first design's library (F and G) and this tree's
    (``color_resample``), their entries typed."""
    first = build({"first": parent}, ("exact_color.cu", "pil_resample.cu"),
                  out_dir)["first"]
    first.vqa_exact_color.argtypes = [_P] * 4 + [_I] * 28 + [_P, _P]
    first.vqa_pil_resample.argtypes = [_P, _I, _I, _P, _I, _I, _I, _P, _P]
    this = build({"this": CSRC}, ("exact_color_resample.cu",),
                 out_dir)["this"]
    this.vqa_color_resample.argtypes = _native._SIGNATURES[
        "vqa_color_resample"]
    return first, this


def graph(fn):
    """``fn``'s launches captured once in a CUDA graph."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g


def replay_ms(g) -> float:
    """Mean ms of one replay of ``g`` over ``ITERS``, by CUDA events."""
    g.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ITERS):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv) -> int:
    batches = BATCHES
    if argv and argv[-1].startswith("--batches="):
        batches = tuple(int(b) for b in argv[-1].split("=", 1)[1].split(","))
        argv = argv[:-1]
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    with open(os.path.join(FIXTURES, f"{LOAD_FIXTURE}.jpg"), "rb") as fd:
        data = image_formats.read_jpeg(fd.read())
    planes = X.exact_idct_cuda(
        [torch.from_numpy(c).to(device) for c in data.coefficients],
        [torch.from_numpy(q).to(device) for q in data.qtables])
    plan = X.resample_plan(data.width, data.height, 224, 0.875)
    taps = torch.from_numpy(plan.taps.copy()).to(device)
    moved, ops = color_resample_work(plan, data.components)
    comps = data.components
    pad = 4 - len(comps)

    def field(values):
        return [*values, *[1] * pad]

    results = {"card": card(), "batches": {}}
    print(results["card"])
    with tempfile.TemporaryDirectory() as out_dir:
        first, this = load(argv[0], out_dir)
        for n in batches:
            copies = [X.Planes([p.clone() for p in planes], comps,
                               data.color_space, data.width, data.height)
                      for _ in range(n)]
            rgb = [torch.empty(data.height, data.width, 3, dtype=torch.uint8,
                               device=device) for _ in range(n)]
            out_first = torch.empty(n, 224, 224, 3, dtype=torch.uint8,
                                    device=device)
            batch = X.color_resample_batch(copies, [plan] * n)

            def run_first():
                stream = _native.stream_ptr(device)
                for image, rgb_i, out_i in zip(copies, rgb, out_first):
                    code = first.vqa_exact_color(
                        *[p.data_ptr() for p in image.planes],
                        *[None] * pad,
                        *field(p.shape[1] for p in image.planes),
                        *field(c.width for c in comps),
                        *field(c.height for c in comps),
                        *field(c.max_h // c.h for c in comps),
                        *field(c.max_v // c.v for c in comps),
                        *field(X.upsample_method(c) for c in comps),
                        len(comps), data.color_space, data.width,
                        data.height, rgb_i.data_ptr(), stream)
                    assert code == 0, f"exact_color: CUDA error {code}"
                    code = first.vqa_pil_resample(
                        rgb_i.data_ptr(), plan.in_w, plan.in_h,
                        taps.data_ptr(), plan.kx, plan.ky, plan.size,
                        out_i.data_ptr(), stream)
                    assert code == 0, f"pil_resample: CUDA error {code}"

            def run_this():
                code = this.vqa_color_resample(
                    batch.images.data_ptr(), batch.tiles.data_ptr(),
                    len(batch.tiles), batch.smem,
                    _native.stream_ptr(device))
                assert code == 0, f"color_resample: CUDA error {code}"

            want = X.color_resample_reference(copies, [plan] * n)
            run_first()
            run_this()
            torch.cuda.synchronize()
            same = {"first": bool(torch.equal(out_first, want)),
                    "this": bool(torch.equal(batch.out, want))}
            graphs = {"first": graph(run_first), "this": graph(run_this)}
            times = {name: [] for name in graphs}
            for name in ("first", "this", "this", "first"):
                times[name].append(replay_ms(graphs[name]))
            bound = max(n * moved / HBM_BYTES_PER_S,
                        n * ops / PEAK_32BIT_OPS) * 1e3
            entry = {"bits_equal_plain": same, "bound_ms": bound,
                     "tiles": len(batch.tiles), "smem": batch.smem}
            for name, ms in times.items():
                mean = sum(ms) / len(ms)
                entry[name] = {"ms": mean, "runs_ms": ms,
                               "us_per_image": mean * 1e3 / n,
                               "share_of_bound": bound / mean}
                print(f"N = {n} {name}: {mean * 1e3:.3f} us "
                      f"({', '.join(f'{t * 1e3:.3f}' for t in ms)}), "
                      f"{mean * 1e3 / n:.3f} us an image, {bound / mean:.1%} "
                      f"of the {bound * 1e3:.3f} us bound; plain bits "
                      f"{same[name]}")
            results["batches"][str(n)] = entry
            del graphs, copies, rgb, out_first, batch, want
    print(json.dumps({"compare_exact": results}))
    return 0 if all(all(e["bits_equal_plain"].values())
                    for e in results["batches"].values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
