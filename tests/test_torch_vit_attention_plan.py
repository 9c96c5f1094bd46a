"""Kernels 4 and 5's plan, on the CPU.

``ops/vit_attention.py::attention_plan`` is the only place that decides how
kernels 4 and 5 take a shape: bf16 heads of 64 and 128 past 256 tokens go to
the wgmma kernels (``csrc/vit_attention_wgmma.cuh``), whose C entries take
the plan's tiling as it is; every other shape keeps the kernels it had. Here
the design of each shape of the card tests and of the 448-px ViT, its shared
memory against a block's, its grids against ``backward_grids``, the rows its
blocks cover, and the layout constants the C header shares with it. The
card tests hold the kernels themselves.
"""

import os
import re

import pytest
import torch

from dl_vqa_tpu_torch.ops import _native
from dl_vqa_tpu_torch.ops import vit_attention as va
from dl_vqa_tpu_torch.ops.vit_attention import (
    AttentionPlan,
    attention_plan,
    backward_grids,
)

SMS = 132  # an H100 SXM's
# (images, seq, heads, head): the 448-px ViT at B = 512, 8 and 1, the card
# tests' shapes past 256 tokens, and shapes at or below it.
SHAPES = [(512, 784, 4, 64), (8, 784, 4, 64), (1, 784, 4, 64),
          (2, 257, 1, 64), (1, 400, 2, 64), (1, 1024, 2, 64),
          (1, 257, 1, 128), (1, 784, 2, 128), (1, 300, 2, 192),
          (1, 333, 1, 256), (512, 196, 4, 64), (1, 256, 2, 64),
          (3, 50, 1, 192), (2, 256, 1, 128)]
DTYPES = [torch.bfloat16, torch.float32]


def _plan(dtype, batch, seq, heads, head, sms=SMS):
    return attention_plan(dtype, head, seq, batch * heads, sms)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("batch,seq,heads,head", SHAPES)
def test_the_design_of_each_shape(dtype, batch, seq, heads, head):
    """wgmma exactly for bf16 heads of 64 and 128 past 256 tokens; the
    kernels the shape had before otherwise; never wgmma at or below 256."""
    plan = _plan(dtype, batch, seq, heads, head)
    if seq <= va.ROW_SEQ:
        want = "rows_mma" if dtype == torch.bfloat16 else "rows_fma"
    elif dtype == torch.float32:
        want = "key_tiles_fma"
    else:
        want = "wgmma" if head in (64, 128) else "key_tiles_mma"
    assert plan.design == want
    assert plan.c_args()[0] == (1 if want == "wgmma" else 0)
    if want != "wgmma":  # the C dispatch tiles these as it always has
        assert plan.c_args()[1:7] == (0,) * 6


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("batch,seq,heads,head", SHAPES)
def test_grids_and_statistics_follow_the_plan(dtype, batch, seq, heads,
                                              head):
    """``backward_grids`` is the plan's; two grids have a statistics row of
    at least S (a whole number of 64-query ring tiles for wgmma, S for the
    older kernels, which index it by S), one grid none."""
    plan = _plan(dtype, batch, seq, heads, head)
    assert backward_grids(dtype, head, seq) == plan.grids
    one = dtype == torch.bfloat16 and head == 64 and seq <= va.ROW_SEQ
    assert plan.grids == (1 if one else 2)
    if plan.grids == 1:
        assert plan.stats_len == 0
    elif plan.design == "wgmma":
        assert plan.stats_len >= seq and plan.stats_len % va.RING_ROWS == 0
        assert plan.stats_len - seq < va.RING_ROWS
    else:
        assert plan.stats_len == seq


@pytest.mark.parametrize("batch,seq,heads,head", [
    s for s in SHAPES if s[1] > 256 and s[3] in (64, 128)])
def test_wgmma_plans_fit_a_block(batch, seq, heads, head):
    """Each of the three kernels' shared memory: the block's own rows, the
    ring and the mbarriers, within an sm_90 block's 232,448 bytes, with at
    least two stages, one computed on while the next one loads."""
    plan = _plan(torch.bfloat16, batch, seq, heads, head)
    slices = head // 64
    own = slices * plan.rows * 128
    stage = 2 * slices * 64 * 128
    assert va.RING_MIN_STAGES <= plan.stages <= va.RING_STAGES
    assert plan.key_tile == va.RING_ROWS
    assert plan.shared == va.ring_shared(own, stage, plan.stages)
    assert plan.shared_dq == va.ring_shared(2 * own, stage, plan.stages)
    assert plan.shared_dkdv == va.ring_shared(2 * own, stage + 1024,
                                              plan.stages)
    for shared in (plan.shared, plan.shared_dq, plan.shared_dkdv):
        assert shared <= va.SMEM_PER_BLOCK


@pytest.mark.parametrize("seq", [257, 300, 784, 1000, 1024])
@pytest.mark.parametrize("pairs", [1, 4, 32, 64, 2048])
def test_blocks_cover_every_row_once(seq, pairs):
    """The grid of ceil(S / rows) blocks, a consumer warpgroup for each 64
    rows that start before S (csrc ``consumers``), covers rows 0 .. S - 1
    once; the block size takes no more costed waves than any other."""
    plan = attention_plan(torch.bfloat16, 64, seq, pairs, SMS)
    blocks = -(-seq // plan.rows)

    def cost(n):
        return -(-pairs * -(-seq // (64 * n)) // SMS) * va.BLOCK_COST[n]

    assert cost(plan.rows // 64) == min(cost(n) for n in (1, 2, 3))
    covered = []
    for block in range(blocks):
        row0 = block * plan.rows
        active = min(plan.rows // 64, -(-(seq - row0) // 64))
        assert active >= 1
        for c in range(active):
            covered.extend(range(row0 + 64 * c,
                                 min(row0 + 64 * (c + 1), seq)))
    assert covered == list(range(seq))


@pytest.mark.parametrize("head", [64, 128])
def test_block_sizes_of_the_448_px_vit(head):
    """Two heads at S = 784 on 132 SMs: blocks of one consumer at B = 1,
    two at B = 8, three at B = 512 (the card test of their bits)."""
    assert [attention_plan(torch.bfloat16, head, 784, 2 * b, SMS).rows
            for b in (1, 8, 512)] == [64, 128, 192]


def test_the_plan_does_not_depend_on_the_card_but_for_its_rows():
    """Only the rows a block depend on the batch and the SM count; the
    design, the ring and the grids do not."""
    plans = [attention_plan(torch.bfloat16, 64, 784, pairs, sms)
             for pairs in (1, 32, 4096) for sms in (78, 114, 132)]
    keys = {(p.design, p.key_tile, p.grids, p.stats_len) for p in plans}
    assert len(keys) == 1
    assert {p.rows for p in plans} == {64, 128, 192}


def test_c_args_match_the_entries():
    """Both C entries take the eight ints of ``c_args`` after the dtype
    code, and the Python layout constants are the C header's."""
    plan = attention_plan(torch.bfloat16, 64, 784, 2048, SMS)
    assert isinstance(plan, AttentionPlan) and len(plan.c_args()) == 8
    fwd = _native._SIGNATURES["vqa_vit_attention"]
    bwd = _native._SIGNATURES["vqa_vit_attention_backward"]
    assert len(fwd) == 9 + 8 + 1 and len(bwd) == 10 + 8 + 1
    path = os.path.join(os.path.dirname(_native.__file__), os.pardir, "csrc",
                        "vit_attention_wgmma.cuh")
    with open(path) as fd:
        header = fd.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             header).group(1))

    assert constant("kRingRows") == va.RING_ROWS
    assert "3 * kRingRows" in header  # blocks of up to three consumers
    assert constant("kStatBytes") == 1024
    assert constant("kBarrierBytes") == 128
    assert va.RING_STAGES <= constant("kMaxStages")
    assert va.RING_MIN_STAGES == constant("kMinStages")
    assert 8 * (2 * constant("kMaxStages") + 1) <= constant("kBarrierBytes")
