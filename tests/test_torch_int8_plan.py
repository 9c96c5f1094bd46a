"""Kernel D's plan and its wgmma weight packing, on the CPU.

``ops/conv_int8.py::w8a8_plan`` is the only plan of kernel D
(``csrc/conv_relu_pool_int8.cu``): it sends the reference model's conv1
and conv2 to the wgmma kernel within a block's shared memory, and stride
2, an even filter and narrow inputs to the mma.sync kernel; its tiles
cover every pooled output once at any batch. ``pack_int8_weight_wgmma``
read back through wgmma's swizzled layout gives the ``[K, Cout]`` matrix,
and an emulation of the wgmma kernel's tile walk (its window, its
ldmatrix rows, its K offsets into the packed weight, its epilogue) gives
the plain version's codes. The card tests hold the kernel itself.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.ops import conv_int8
from dl_vqa_tpu_torch.ops.conv_fused import SMEM_PER_BLOCK
from dl_vqa_tpu_torch.ops.conv_int8 import (
    W8A8_PAD,
    MmaSyncPlan,
    WgmmaPlan,
    pack_int8_weight_wgmma,
    w8a8_plan,
)
from dl_vqa_tpu_torch.ops.wgmma_layout import swizzle_index, swizzle_k_major

SMS = 132  # an H100 SXM's; only the grid's size depends on it
# Kernel D's blocks in the reference model: input size, Cin, Cout (k = 3),
# and the share of computed pool windows its tile masks.
MODEL_BLOCKS = [(111, 64, 128, 2, 2, 0.0357), (54, 128, 256, 4, 1, 0.1378)]


def read_back(packed, cout, kdim):
    """[atoms, Cout_pad, 128] swizzled bytes -> the [Cout_pad, atoms 128]
    matrix, by the formula of csrc/wgmma.cuh: byte c of row r of an atom
    lies in piece (c / 16) ^ (r % 8)."""
    atoms, rows, width = packed.shape
    out = np.zeros((rows, atoms * width), np.int64)
    for r in range(rows):
        for c in range(atoms * width):
            atom, byte = divmod(c, width)
            out[r, c] = packed[atom, r, ((byte // 16) ^ (r % 8)) * 16
                               + byte % 16]
    return out


@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 256), (64, 136),
                                      (32, 64), (96, 72)])
def test_wgmma_packing_reads_back_as_the_k_by_cout_matrix(cin, cout):
    """K runs (di, dj, ci) end to end across atoms, zero past 9 Cin and
    past Cout up to the plan's slice."""
    rng = np.random.default_rng(cin + cout)
    w_q = rng.integers(-127, 128, (cout, cin, 3, 3)).astype(np.int8)
    plan = w8a8_plan(40, 40, cin, cout, 3, 1, SMS)
    assert plan.kernel == "wgmma"
    packed = pack_int8_weight_wgmma(torch.from_numpy(w_q), plan).numpy()
    cout_pad = -(-cout // plan.channels) * plan.channels
    assert packed.shape == (plan.atoms, cout_pad, 128)
    assert plan.atoms == -(-9 * cin // 128)
    matrix = read_back(packed, cout, plan.atoms * 128)
    want = np.zeros((cout_pad, plan.atoms * 128), np.int64)
    want[:cout, :9 * cin] = w_q.transpose(0, 2, 3, 1).reshape(cout, -1)
    np.testing.assert_array_equal(matrix, want)


@pytest.mark.parametrize("rows,k", [(8, 64), (32, 128), (128, 192)])
def test_bf16_swizzle_index_is_unchanged(rows, k):
    """The bf16 index of kernels 6 and 8, as it was before the index took
    1-byte values: 64 values a row, pieces of 8."""
    atom = torch.arange(k // 64)[:, None, None]
    row = torch.arange(rows)[None, :, None]
    col = torch.arange(64)[None, None, :]
    piece = (col // 8) ^ (row % 8)
    want = (row * k + atom * 64 + piece * 8 + col % 8).reshape(-1)
    assert torch.equal(swizzle_index(rows, k, torch.device("cpu")), want)
    t = torch.randn(2, rows, k).to(torch.bfloat16)
    assert torch.equal(swizzle_k_major(t).reshape(2, -1),
                       t.reshape(2, -1)[:, want])


def test_int8_swizzle_places_every_piece_once():
    index = swizzle_index(16, 256, torch.device("cpu"), 1)
    assert sorted(index.tolist()) == list(range(16 * 256))
    t = torch.arange(16 * 256).reshape(16, 256).to(torch.int32) % 100
    packed = swizzle_k_major(t.to(torch.int8), 1)
    assert packed.shape == (2, 16, 128)


@pytest.mark.parametrize("size,cin,cout,rows,cols,masked", MODEL_BLOCKS)
def test_model_blocks_take_the_wgmma_kernel(size, cin, cout, rows, cols,
                                            masked):
    plan = w8a8_plan(size, size, cin, cout, 3, 1, SMS)
    assert isinstance(plan, WgmmaPlan) and plan.kernel == "wgmma"
    assert (plan.warp_rows, plan.warp_cols) == (rows, cols)
    assert plan.channels == 128 and plan.ck == cin
    hp = (size - 2) // 2
    assert (plan.tiles_y, plan.tiles_x) == (-(-hp // rows),
                                            -(-hp // (4 * cols)))
    # The share of the computed pool windows outside the output.
    share = 1 - hp * hp / (plan.tiles_y * plan.tiles_x * 16)
    assert share == pytest.approx(masked, abs=1e-4)
    # A stage: the tile's window of conv positions and its halo, ck + pad
    # bytes a pixel, 16-byte aligned for cp.async and ldmatrix.
    assert plan.stage_bytes == (2 * rows + 2) * (8 * cols + 2) * (
        cin + W8A8_PAD)
    assert plan.stage_bytes % 16 == 0
    assert plan.shared == (plan.atoms * plan.channels * 128
                           + 4 * plan.stage_bytes + 1024 + 1024)
    assert plan.shared <= SMEM_PER_BLOCK
    assert plan.blocks == SMS // (cout // 128)
    # conv1: 5 atoms of K (9 x 64 = 576 bytes, half an atom a tap), 80 KB
    # of weights; conv2: 9 atoms, 144 KB of one 128-channel slice.
    assert plan.atoms * plan.channels * 128 == {64: 81920, 128: 147456}[cin]


@pytest.mark.parametrize("sms", [1, 114, SMS])
def test_grid_follows_the_sm_count(sms):
    """Only the grid's size depends on the card: conv2's two slices share
    the SMs, and every slice has at least one block."""
    plans = [w8a8_plan(54, 54, 128, 256, 3, 1, n) for n in (sms, SMS)]
    assert plans[0].blocks == max(1, sms // 2)
    assert dataclasses.replace(plans[0], blocks=0) == dataclasses.replace(
        plans[1], blocks=0)


@pytest.mark.parametrize("h,cin,cout,k,stride", [
    (31, 48, 24, 3, 2),    # stride 2
    (19, 128, 8, 2, 1),    # an even filter
    (5, 4, 8, 3, 1),       # Cin = 4
    (21, 36, 20, 3, 1),    # Cin off the 32-deep K step
    (30, 64, 30, 3, 1),    # Cout off the 4-byte store
    (40, 64, 136, 3, 2),   # Cout over one block of 128, stride 2
    (270, 32, 16, 3, 2),   # a wide stride-2 row: 67 pooled columns
])
def test_other_shapes_take_the_mma_sync_kernel(h, cin, cout, k, stride):
    plan = w8a8_plan(h, h, cin, cout, k, stride, SMS)
    assert isinstance(plan, MmaSyncPlan) and plan.kernel == "mma_sync"
    assert plan.shared == (stride + k) * h * plan.pixel_bytes
    assert plan.shared <= SMEM_PER_BLOCK
    c_args = plan.c_args()
    assert len(c_args) == len(w8a8_plan(54, 54, 128, 256, 3, 1,
                                         SMS).c_args())
    assert c_args[0] == 0 and c_args[9] == plan.pixel_bytes


def test_no_plan_where_no_kernel_fits():
    assert w8a8_plan(20000, 20000, 64, 64, 3, 2, SMS) is None
    assert w8a8_plan(9, 9, 6, 8, 3, 1, SMS) is None  # Cin off 4
    assert w8a8_plan(2, 2, 8, 8, 3, 1, SMS) is None  # smaller than the filter


def test_plan_does_not_depend_on_the_batch():
    """The plan takes no batch (a pooled pixel's code cannot depend on
    it); a slice's grid is fixed by the SM count, and the launch only trims
    it where the batch has fewer tiles. The walk below covers B = 1 and B =
    512 with the one plan."""
    params = tuple(inspect.signature(w8a8_plan).parameters)
    assert params == ("h", "w", "cin", "cout", "k", "stride", "sms")


def tile_walk(plan, batch, hp, wp):
    """The pooled outputs (b, i, j) each warpgroup's tiles store, as the
    kernel's pool_store indexes them, over all warps and even lanes."""
    tiles_img = plan.tiles_y * plan.tiles_x
    seen = []
    for t in range(batch * tiles_img):
        b, tile = divmod(t, tiles_img)
        for warp in range(4):
            wrow, wcol = divmod(warp, plan.warp_cols)
            for g in range(0, 8, 2):
                i = tile // plan.tiles_x * plan.warp_rows + wrow
                j = tile % plan.tiles_x * 4 * plan.warp_cols + 4 * wcol + g // 2
                if i < hp and j < wp:
                    seen.append((b, i, j))
    return seen


@pytest.mark.parametrize("batch", [1, 512])
@pytest.mark.parametrize("size,cin,cout", [(111, 64, 128), (54, 128, 256),
                                           (13, 32, 64), (20, 96, 136)])
def test_tiles_cover_every_pooled_output_once(batch, size, cin, cout):
    plan = w8a8_plan(size, size, cin, cout, 3, 1, SMS)
    hp = wp = (size - 2) // 2
    seen = tile_walk(plan, batch, hp, wp)
    assert len(seen) == len(set(seen)) == batch * hp * wp


def emulate_wgmma_kernel(x_q, w_q, mult, bias, scale, plan):
    """The wgmma kernel's arithmetic on the CPU: each tile's window staged
    with zeros past the image, each tap's A rows read at the shifted
    window pixel, each k32 step's B rows read from the packed weight at the
    kernel's K offset (tap Cin + c_off + 32 q: atom kk / 128, byte kk %
    128, through the swizzle), exact sums, then finish, the pool and the
    store of what lies inside the output."""
    batch, h, w, cin = x_q.shape
    cout = w_q.shape[0]
    hp, wp = (h - 2) // 2, (w - 2) // 2
    packed = pack_int8_weight_wgmma(torch.from_numpy(w_q), plan).numpy()
    matrix = read_back(packed, cout, plan.atoms * 128)  # [Cout_pad, K]
    out = np.full((batch, hp, wp, cout), -1, np.int64)
    in_h, in_w = 2 * plan.warp_rows + 2, 8 * plan.warp_cols + 2
    for t in range(batch * plan.tiles_y * plan.tiles_x):
        b, tile = divmod(t, plan.tiles_y * plan.tiles_x)
        y0 = tile // plan.tiles_x * 2 * plan.warp_rows
        x0 = tile % plan.tiles_x * 8 * plan.warp_cols
        window = np.zeros((in_h, in_w, cin), np.int64)
        part = x_q[b, y0:y0 + in_h, x0:x0 + in_w]
        window[:part.shape[0], :part.shape[1]] = part
        acc = np.zeros((4, 16, matrix.shape[0]), np.int64)  # warp, row, n
        for c_off in range(0, cin, plan.ck):
            for tap in range(9):
                di, dj = divmod(tap, 3)
                for q in range(plan.ck // 32):
                    kk = tap * cin + c_off + 32 * q
                    bmat = matrix[:, kk // 128 * 128 + kk % 128:][:, :32]
                    for warp in range(4):
                        wrow, wcol = divmod(warp, plan.warp_cols)
                        for r in range(16):
                            py = 2 * wrow + r // 8 + di
                            px = 8 * wcol + r % 8 + dj
                            a = window[py, px, c_off + 32 * q:][:32]
                            acc[warp, r] += bmat @ a
        for warp in range(4):
            wrow, wcol = divmod(warp, plan.warp_cols)
            i = tile // plan.tiles_x * plan.warp_rows + wrow
            for p in range(4):
                j = tile % plan.tiles_x * 4 * plan.warp_cols + 4 * wcol + p
                if i >= hp or j >= wp:
                    continue
                rows = [2 * p, 2 * p + 1, 8 + 2 * p, 9 + 2 * p]
                y = conv_int8.fma_f32(
                    torch.from_numpy(acc[warp, rows, :cout]).float(), mult,
                    bias)
                codes = torch.clamp(torch.round(torch.relu(y) * scale),
                                    max=127)
                out[b, i, j] = codes.amax(dim=0).numpy()
    return out


@pytest.mark.parametrize("size,cin,cout", [(13, 64, 72), (14, 32, 64),
                                           (11, 96, 136)])
def test_emulated_wgmma_kernel_gives_the_plain_codes(size, cin, cout):
    rng = np.random.default_rng(size + cin)
    x_q = rng.integers(0, 128, (2, size, size + 3, cin)).astype(np.int8)
    w = torch.from_numpy(
        (rng.standard_normal((cout, cin, 3, 3)) * 0.05).astype(np.float32))
    b = torch.from_numpy(
        (rng.standard_normal(cout) * 0.2).astype(np.float32))
    s_in, s_out = 3.0, 4.0
    plan = w8a8_plan(size, size + 3, cin, cout, 3, 1, SMS)
    assert plan.kernel == "wgmma"
    w_q, mult = conv_int8._epilogue_scales(w, s_in)
    got = emulate_wgmma_kernel(x_q, w_q.numpy(), mult, b,
                               conv_int8.f32(127.0 / s_out), plan)
    want = conv_int8.conv_relu_pool_w8a8_reference(
        torch.from_numpy(x_q), s_in, w, b, 1, s_out).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (want > 0).mean() < 1
