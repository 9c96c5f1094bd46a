"""The f32 persistent LSTM kernel's host side, on the CPU: its plan
(``ops/lstm_cuda.py::f32_plan``), the Python mirror of its shared-memory
layout against the CUDA source, the order it takes the rows in
(``row_order``), and the row invariance the kernel relies on when it
computes the rows of a batch in that order."""

import os
import re

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.ops import lstm_cuda
from dl_vqa_tpu_torch.ops.lstm import (
    lstm_recurrence_reference,
    lstm_token_states_reference,
)
from dl_vqa_tpu_torch.ops.lstm_cuda import (
    SMEM_PER_BLOCK,
    f32_plan,
    f32_smem_bytes,
    persistent_plan,
    row_order,
)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
SOURCE = os.path.join(os.path.dirname(lstm_cuda.__file__), os.pardir, "csrc",
                      "lstm_recurrence.cu")


@pytest.mark.parametrize("directions", [1, 2])
def test_the_text_encoder_takes_the_f32_kernel_on_132_sms(directions):
    """H = 1024: 128 blocks of 8 units, 128 KiB of W_hh each beside the
    ring of h and half the partial sums, 231,936 bytes of the 232,448 a
    block may use. The
    directions run one after the other, so D does not change the plan."""
    plan = f32_plan(directions, 1024, H100_SXM_SMS)
    assert plan == (128, 231_936)
    assert f32_smem_bytes(1024) <= SMEM_PER_BLOCK
    assert 32 * 1024 * 4 == 128 * 1024  # a block's W_hh rows


@pytest.mark.parametrize("hidden", [16, 32, 48, 64, 272, 1024])
def test_the_card_tests_widths_have_plans(hidden):
    for directions in (1, 2):
        blocks, smem = f32_plan(directions, hidden, H100_SXM_SMS)
        assert blocks == hidden // 8 and smem == f32_smem_bytes(hidden)


@pytest.mark.parametrize("hidden,sms,why", [
    (1040, 10_000, "shared memory"),   # K pads to 1536: W_hh no longer fits
    (2048, 10_000, "shared memory"),
    (1024, H100_PCIE_SMS, "blocks"),   # 128 blocks on 114 SMs
    (64, 7, "blocks"),
    (24, H100_SXM_SMS, "width"),       # not a multiple of 16
    (0, H100_SXM_SMS, "width"),
])
def test_the_shapes_the_plan_refuses(hidden, sms, why):
    """Refused shapes keep the per-step grids: H above 1024 (its W_hh rows
    exceed a block's shared memory), more blocks than SMs, a width off
    16."""
    assert f32_plan(2, hidden, sms) is None
    if why == "shared memory":
        assert f32_smem_bytes(hidden) > SMEM_PER_BLOCK
    elif why == "blocks":
        assert hidden // 8 > sms


def test_a_misaligned_x_proj_takes_the_per_step_grids():
    """The kernel reads x_proj two f32 at a time."""
    assert f32_plan(2, 1024, H100_SXM_SMS, (4096,)) is not None
    assert f32_plan(2, 1024, H100_SXM_SMS, (4100,)) is None
    assert f32_plan(0, 1024, H100_SXM_SMS) is None


def test_every_plan_fits_a_block():
    for hidden in range(16, 4097, 16):
        plan = f32_plan(2, hidden, 10_000)
        if plan is not None:
            assert plan[1] <= SMEM_PER_BLOCK and hidden <= 1024


def test_the_bf16_plan_is_unchanged():
    """f32 still has no plan of the bf16 kernel; bf16's answers at the
    model's shapes are those of before."""
    assert persistent_plan(2, 1024, torch.float32, H100_SXM_SMS) is None
    assert persistent_plan(2, 1024, torch.bfloat16, H100_SXM_SMS)[:2] == (
        16, 128)
    assert persistent_plan(1, 1024, torch.bfloat16, H100_SXM_SMS)[:2] == (
        8, 128)
    assert persistent_plan(2, 1024, torch.bfloat16, H100_PCIE_SMS) is None


def test_mirror_matches_the_cuda_source():
    """``f32_smem_bytes`` repeats the constants of the source's ``namespace
    persistent_f32``; the C entry refuses other bytes, so a drift would
    raise on the card."""
    with open(SOURCE) as fd:
        source = fd.read()
    body = source[source.index("namespace persistent_f32 {"):
                  source.index("}  // namespace persistent_f32")]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", body))
    assert int(consts["kUnits"]) == lstm_cuda._F32_UNITS
    assert int(consts["kKAlign"]) == lstm_cuda._F32_K_ALIGN
    assert int(consts["kWPad"]) == lstm_cuda._F32_WPAD
    assert int(consts["kRingSlots"]) == lstm_cuda._F32_STAGES
    assert int(consts["kRedRows"]) * 32 * 4 == lstm_cuda._F32_RED_FLOATS
    assert "kStageFloats = 64 * 132;" in body
    assert lstm_cuda._F32_STAGE_FLOATS == 64 * 132
    # 32 rows of K padded to 1024 and 4 more, two slots, four warps' sums.
    assert f32_smem_bytes(1024) == 4 * (32 * 1028 + 2 * 8448 + 8192)
    assert f32_smem_bytes(272) == 4 * (32 * 516 + 2 * 8448 + 8192)


def test_row_order_of_a_ragged_batch():
    """Longest first, ties in batch order; live[t] counts the rows with t <
    len, and they are the first live[t] of the order at every step."""
    lengths = torch.tensor([3, 0, 5, 3, 1, 5, 2], dtype=torch.int32)
    order, live = row_order(lengths, 6)
    assert order.dtype == live.dtype == torch.int32
    assert order.tolist() == [2, 5, 0, 3, 6, 4, 1]
    assert live.tolist() == [6, 5, 4, 2, 2, 0]
    for t in range(6):
        inside = {b for b in range(7) if t < int(lengths[b])}
        assert set(order[:int(live[t])].tolist()) == inside


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_order_at_random(seed):
    rng = np.random.default_rng(seed)
    batch, seq_len = int(rng.integers(1, 600)), int(rng.integers(1, 30))
    lengths = torch.from_numpy(
        rng.integers(0, seq_len + 1, batch).astype(np.int32))
    order, live = row_order(lengths, seq_len)
    assert sorted(order.tolist()) == list(range(batch))
    sorted_lengths = lengths[order.long()]
    assert bool((sorted_lengths[:-1] >= sorted_lengths[1:]).all())
    for t in range(seq_len):
        assert int(live[t]) == int((lengths > t).sum())
        assert bool((sorted_lengths[:int(live[t])] > t).all())
    assert list(live.tolist()) == sorted(live.tolist(), reverse=True)


def _inputs(seed, directions=2, seq_len=7, batch=19, hidden=32):
    rng = np.random.default_rng(seed)
    x_proj = torch.from_numpy(rng.standard_normal(
        (directions, seq_len, batch, 4 * hidden)).astype(np.float32) * 0.5)
    w_hh = torch.from_numpy(((rng.random(
        (directions, 4 * hidden, hidden)) * 2 - 1) / hidden ** 0.5).astype(
            np.float32))
    lengths = torch.from_numpy(
        rng.integers(0, seq_len + 1, batch).astype(np.int32))
    return x_proj, w_hh, lengths


@pytest.mark.parametrize("seed", [0, 1])
def test_the_plain_recurrence_on_ordered_rows_is_the_same_bits(seed):
    """The kernel computes the rows in ``row_order``: the plain token
    states and final state of the reordered batch, put back in batch order,
    equal those of the batch as it came, to the bit. Each row's arithmetic
    is the same wherever the row sits."""
    x_proj, w_hh, lengths = _inputs(seed)
    order, _ = row_order(lengths, x_proj.shape[1])
    order = order.long()
    back = torch.argsort(order)
    h_all, c = lstm_token_states_reference(x_proj, w_hh, lengths)
    h_all_o, c_o = lstm_token_states_reference(
        x_proj[:, :, order].contiguous(), w_hh, lengths[order].contiguous())
    assert torch.equal(h_all_o[:, :, back], h_all)
    assert torch.equal(c_o[:, back], c)
    h, c1 = lstm_recurrence_reference(x_proj, w_hh, lengths)
    h_o, c1_o = lstm_recurrence_reference(
        x_proj[:, :, order].contiguous(), w_hh, lengths[order].contiguous())
    assert torch.equal(h_o[:, back], h) and torch.equal(c1_o[:, back], c1)


def test_the_f32_wrappers_count_their_own_launches():
    """Each of the three f32 entries carries a count of the f32 persistent
    kernel's launches beside its count of all grids."""
    for fn in (lstm_cuda.lstm_recurrence_cuda,
               lstm_cuda.lstm_recurrence_save_cuda,
               lstm_cuda.lstm_token_states_cuda):
        assert isinstance(fn.launches, int)
        assert isinstance(fn.launches_f32_persistent, int)


def test_cpu_tensors_never_reach_the_f32_kernel():
    args = _inputs(0)
    for run in (lstm_cuda.lstm_recurrence_cuda,
                lstm_cuda.lstm_recurrence_save_cuda,
                lstm_cuda.lstm_token_states_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            run(*args)
