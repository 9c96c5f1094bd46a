"""Kernels 6 and 8's plans and weight packings, on the CPU.

Kernel 6's tiling (``ops/conv_fused.py::fused_plan``) covers every pooled
output once, masks less than 15% of the computed windows at the model's
two blocks, and streams the weights where they do not fit, so that every
shape the mma.sync kernel took still has a plan; both kernels' wgmma
weight packings round-trip and put every value where ``csrc/wgmma.cuh``'s
swizzle formula says, a formula that places every 16-byte piece of a tile
once; kernel 8's rows-per-block choice
(``ops/vit_mlp_fused.py::row_plan``) at the served and trained batches.
The card tests hold the C entry's plan to this one.
"""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.ops import conv_fused
from dl_vqa_tpu_torch.ops.conv_fused import (
    SMEM_PER_BLOCK,
    fused_plan,
    pack_conv_weight,
)
from dl_vqa_tpu_torch.ops.vit_mlp_fused import pack_weights, row_plan

CSRC = os.path.join(os.path.dirname(conv_fused.__file__), os.pardir, "csrc")
H100_SXM_SMS = 132
# Kernel 6's blocks in the reference model: input size, Cin, Cout (k = 3).
MODEL_BLOCKS = [(111, 64, 128), (54, 128, 256)]
# Odd bf16 shapes the card tests and chip_smoke.py give kernel 6.
ODD_SHAPES = [(37, 37, 16, 32, 3), (24, 24, 16, 32, 5), (20, 41, 32, 64, 3),
              (19, 18, 48, 128, 3), (9, 11, 64, 256, 3), (4, 4, 16, 32, 3),
              (21, 23, 128, 256, 3), (17, 30, 128, 128, 3),
              (25, 60, 64, 128, 3), (13, 77, 32, 64, 3)]
# Shapes whose weights do not fit a block, streamed a filter row a step.
STREAM_SHAPES = [(14, 14, 384, 64, 3), (13, 15, 512, 128, 3),
                 (16, 16, 320, 64, 3), (14, 14, 128, 64, 5),
                 (12, 12, 256, 32, 5), (20, 17, 336, 96, 3)]
SHAPES = [(size, size, cin, cout, 3) for size, cin, cout in MODEL_BLOCKS] + \
    ODD_SHAPES + STREAM_SHAPES


def swizzle_offset(row, col, rows):
    """Byte offset of bf16 value (row, col) in a swizzled tile of `rows`
    rows, as csrc/wgmma.cuh's comment and swizzle_offset state it."""
    return ((col // 64) * rows * 128 + row * 128
            + (((col % 64) // 8) ^ (row % 8)) * 16 + (col % 8) * 2)


def unswizzle(packed):
    """[..., A, R, 64] swizzled tiles -> [..., R, 64 A], by the formula."""
    *lead, atoms, rows, width = packed.shape
    flat = packed.reshape(-1, atoms * rows * width)
    out = torch.empty_like(flat)
    for r in range(rows):
        for c in range(0, atoms * width, 8):
            place = swizzle_offset(r, c, rows) // 2
            out[:, r * atoms * width + c:r * atoms * width + c + 8] = \
                flat[:, place:place + 8]
    return out.reshape(*lead, rows, atoms * width)


def plan_windows(plan):
    """Every pool window (i, j) one image's tiles compute, masked ones
    included, in the kernel's arithmetic: tile (ty, tx), warp (wrow, wcol),
    lane pair q make window (ty warp_rows + wrow, tx 4 warp_cols + 4 wcol +
    q)."""
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            for warp in range(4):
                wrow, wcol = divmod(warp, plan.warp_cols)
                for q in range(4):
                    yield (ty * plan.warp_rows + wrow,
                           tx * 4 * plan.warp_cols + 4 * wcol + q)


@pytest.mark.parametrize("h,w,cin,cout,k", SHAPES)
def test_plan_covers_every_pooled_output_once(h, w, cin, cout, k):
    plan = fused_plan(h, w, cin, cout, k)
    assert plan is not None and plan.shared <= SMEM_PER_BLOCK
    hp, wp = (h - k + 1) // 2, (w - k + 1) // 2
    counts = Counter(plan_windows(plan))
    inside = {(i, j): n for (i, j), n in counts.items() if i < hp and j < wp}
    assert len(inside) == hp * wp and set(inside.values()) == {1}
    assert sum(counts.values()) == plan.tiles_y * plan.tiles_x * 16
    assert plan.masked == pytest.approx(1 - hp * wp / sum(counts.values()))


@pytest.mark.parametrize("h,w,cin,cout,k", STREAM_SHAPES)
def test_plan_streams_weights_that_do_not_fit(h, w, cin, cout, k):
    """Even 32 channels' weights for all taps do not fit beside the
    stages, so a step stages one filter row's weights."""
    plan = fused_plan(h, w, cin, cout, k)
    widest = next(c for c in (64, 48, 32, 16) if cin % c == 0)
    resident = conv_fused._shared_bytes(k, plan.warp_rows, plan.warp_cols,
                                        -(-cin // 64), 32, widest, False)
    assert resident > SMEM_PER_BLOCK
    assert plan.stream and plan.shared <= SMEM_PER_BLOCK
    assert cin % plan.ck == 0 and cout % plan.channels == 0


def _mma_sync_staging(k, cout):
    """The shared memory the mma.sync kernel 6 that preceded wgmma asked
    for: two stages of an 8 x 16 conv tile's window at 16 channels and of
    all taps' weights for BN = 128, 64 or 32 channels. It took a shape
    where that fit, whatever Cin."""
    bn = 128 if cout % 128 == 0 else 64 if cout % 64 == 0 else 32
    return 2 * ((8 + k - 1) * (16 + k - 1) * 24 + k * k * 16 * (bn + 8)) * 2


@pytest.mark.parametrize("k", range(1, 14))
def test_plan_takes_every_shape_the_mma_sync_kernel_took(k):
    """Every bf16 shape the mma.sync kernel took (k <= 8) still has a plan,
    and so does every k up to 9; none fits from 12 on."""
    for cin in (16, 48, 64, 320, 512):
        for cout in (32, 64, 96, 128, 256):
            plan = fused_plan(40, 40, cin, cout, k)
            if _mma_sync_staging(k, cout) <= SMEM_PER_BLOCK:
                assert plan is not None, (cin, cout)
            if k <= 9 or k >= 12:
                assert (plan is not None) == (k <= 9), (cin, cout)
            assert plan is None or plan.shared <= SMEM_PER_BLOCK


@pytest.mark.parametrize("size,cin,cout,parent", [
    (111, 64, 128, 0.070), (54, 128, 256, 0.246)])
def test_model_blocks_mask_under_15_percent(size, cin, cout, parent):
    """conv1 and conv2 mask 3.6% and 13.8% of their windows, against the
    8 x 16 tiles' 7.0% and 24.6% before."""
    hp = (size - 2) // 2
    old = 1 - hp * hp / (-(-hp // 4) * 4 * -(-hp // 8) * 8)
    assert old == pytest.approx(parent, abs=1e-3)
    plan = fused_plan(size, size, cin, cout, 3)
    assert plan.masked < 0.15 and plan.masked < old


@pytest.mark.parametrize("cout,cin,k", [(128, 64, 3), (32, 48, 3),
                                        (64, 16, 5), (96, 80, 1)])
def test_conv_packing_round_trips_and_swizzles(cout, cin, k):
    """Value (tap, ci, n) lies at atom ci / 64 of its tap, row n, at the
    byte offset wgmma.cuh's formula gives; Cin is padded with zeros."""
    rng = np.random.default_rng(cout + cin)
    weight = torch.from_numpy(
        rng.standard_normal((cout, cin, k, k)).astype(np.float32))
    packed = pack_conv_weight(weight)
    atoms = -(-cin // 64)
    assert packed.shape == (k * k, atoms, cout, 64)
    per_tap = unswizzle(packed)
    assert not per_tap[..., cin:].any()  # the padding
    assert torch.equal(per_tap[..., :cin].reshape(k, k, cout, cin).permute(
        2, 3, 0, 1), weight)
    flat = packed.reshape(k * k, -1)
    taps = weight.permute(2, 3, 0, 1).reshape(k * k, cout, cin)
    n = torch.arange(cout)[:, None].expand(cout, cin).reshape(-1)
    ci = torch.arange(cin)[None, :].expand(cout, cin).reshape(-1)
    offsets = torch.tensor([swizzle_offset(int(r), int(c), cout) // 2
                            for r, c in zip(n, ci)])
    assert torch.equal(flat[:, offsets], taps.reshape(k * k, -1))
    assert float(flat.abs().sum()) == pytest.approx(float(taps.abs().sum()),
                                                    rel=1e-6)


@pytest.mark.parametrize("hidden,dim", [(1024, 256), (192, 128), (64, 64)])
def test_mlp_packing_round_trips_and_swizzles(hidden, dim):
    """Chunk c of W1 is its rows 64 c .. 64 c + 63 as a [64, D] tile, of W2
    its columns as a [D, 64] tile, each value where the formula says."""
    rng = np.random.default_rng(hidden + dim)
    w1 = torch.from_numpy(rng.standard_normal((hidden, dim)).astype(
        np.float32))
    w2 = torch.from_numpy(rng.standard_normal((dim, hidden)).astype(
        np.float32))
    p1, p2 = pack_weights(w1, w2)
    chunks = hidden // 64
    assert p1.shape == (chunks, dim // 64, 64, 64)
    assert p2.shape == (chunks, 1, dim, 64)
    assert torch.equal(unswizzle(p1).reshape(hidden, dim), w1)
    assert torch.equal(unswizzle(p2).transpose(0, 1).reshape(dim, hidden),
                       w2)
    f, d = (a.ravel() for a in np.meshgrid(np.arange(64), np.arange(dim),
                                           indexing="ij"))
    o1 = [swizzle_offset(int(r), int(c), 64) // 2 for r, c in zip(f, d)]
    o2 = [swizzle_offset(int(r), int(c), dim) // 2 for r, c in zip(d, f)]
    for chunk in {0, chunks - 1}:
        assert torch.equal(p1[chunk].reshape(-1)[o1], w1[64 * chunk + f, d])
        assert torch.equal(p2[chunk].reshape(-1)[o2], w2[d, 64 * chunk + f])


@pytest.mark.parametrize("rows,k", [(64, 256), (256, 64), (64, 64),
                                    (128, 64), (96, 128)])
def test_swizzle_places_every_piece_of_a_tile_once(rows, k):
    """The formula of kernel 8's [64, D] and [D, 64] weight chunks and ln
    tile and of kernel 6's weights: every 16-byte piece of a tile gets its
    own place inside the tile, and the pieces of a row stay in that row's
    128 bytes of their atom."""
    places = {swizzle_offset(r, c, rows) // 16: (r, c)
              for r in range(rows) for c in range(0, k, 8)}
    assert sorted(places) == list(range(rows * k // 8))
    for place, (r, c) in places.items():
        assert place // 8 == (c // 64) * rows + r


def test_swizzle_formula_is_the_header_s():
    """This file's swizzle_offset and wgmma.cuh's are one formula: the
    16-byte piece p of row r at p ^ (r % 8), atoms of R rows."""
    with open(os.path.join(CSRC, "wgmma.cuh")) as fd:
        header = fd.read()
    assert "(((col % 64) / 8) ^ (row % 8)) * 16 + (col % 8) * 2" in header
    assert "(col / 64) * rows * 128 + row * 128" in header
    # Column 70 is atom 1, piece 0, value 6; row 9 permutes piece 0 to 1.
    assert swizzle_offset(9, 70, 16) == 16 * 128 + 9 * 128 + 1 * 16 + 6 * 2


def test_plan_constants_are_the_kernel_s():
    """The Python plan's arrangements, pad, channel slices and warpgroups
    are the ones csrc/conv_relu_pool_fused.cu::make_plan uses."""
    with open(os.path.join(CSRC, "conv_relu_pool_fused.cu")) as fd:
        source = fd.read()
    assert re.search(r"arrangements\[3\]\[2\] = \{\{4, 1\}, \{2, 2\}, "
                     r"\{1, 4\}\}", source)
    assert "constexpr int kPad = 8;" in source
    assert "for (int n : {128, 64, 32})" in source
    assert "constexpr int kWarpgroups = 2;" in source
    assert conv_fused._ARRANGEMENTS == ((4, 1), (2, 2), (1, 4))
    assert conv_fused._PAD == 8 and conv_fused._WARPGROUPS == 2


@pytest.mark.parametrize("batch,sms,plan", [
    (1, H100_SXM_SMS, (1, 64, 4)), (8, H100_SXM_SMS, (1, 64, 25)),
    (512, H100_SXM_SMS, (2, 128, 784)), (512, 114, (2, 128, 784)),
    (64, H100_SXM_SMS, (1, 64, 196))])
def test_mlp_rows_a_block(batch, sms, plan):
    """196 tokens an image: one 64-row warpgroup a block while 128-row
    blocks would leave SMs idle, two from 128 * SMs rows on."""
    assert row_plan(batch * 196, sms) == plan


def test_mlp_row_plan_switches_where_128_row_blocks_fill_the_card():
    for sms in (1, 114, H100_SXM_SMS):
        edge = 128 * sms
        assert row_plan(edge - 1, sms)[0] == 1
        assert row_plan(edge, sms) == (2, 128, sms)
