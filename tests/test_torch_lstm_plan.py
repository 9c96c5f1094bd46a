"""The persistent LSTM kernel's plan (``ops/lstm_cuda.py::persistent_plan``)
and its dispatch rule, on the CPU: which block size the kernel takes at the
main shapes, where it takes none (f32; a W_hh that no SM count holds),
that its shared memory never exceeds what a Hopper block may use, and that
the Python mirror of the kernel's layout agrees with the CUDA source."""

import os
import re

import pytest
import torch

from dl_vqa_tpu_torch.ops import lstm_cuda
from dl_vqa_tpu_torch.ops.lstm_cuda import (
    SMEM_PER_BLOCK,
    persistent_plan,
    persistent_smem_bytes,
)

H100_SXM_SMS = 132
H100_PCIE_SMS = 114
SOURCE = os.path.join(os.path.dirname(lstm_cuda.__file__), os.pardir, "csrc",
                      "lstm_recurrence.cu")


@pytest.mark.parametrize("directions,units", [(2, 16), (1, 8)])
def test_main_shapes_on_132_sms(directions, units):
    """The text encoder at H = 1024: the bi-LSTM (D = 2) takes 16 units a
    block on 128 blocks, 128 KiB of W_hh each; lstm_scan (D = 1) 8 units on
    128 blocks, 64 KiB."""
    plan = persistent_plan(directions, 1024, torch.bfloat16, H100_SXM_SMS)
    assert plan is not None
    got_units, blocks, smem = plan
    assert (got_units, blocks) == (units, 128)
    assert smem == persistent_smem_bytes(units, 1024) <= SMEM_PER_BLOCK
    assert 4 * units * 1024 * 2 == {16: 128, 8: 64}[units] * 1024  # W_hh


def test_f32_has_no_plan():
    """f32's W_hh (32 MiB at H = 1024, D = 2) fits on no card's shared
    memory: f32 keeps the per-step grids at every shape."""
    for hidden in (16, 48, 272, 1024):
        for directions in (1, 2):
            assert persistent_plan(directions, hidden, torch.float32,
                                   H100_SXM_SMS) is None


@pytest.mark.parametrize("sms", [1, H100_PCIE_SMS, H100_SXM_SMS, 10_000])
def test_a_w_hh_that_fits_nowhere_has_no_plan(sms):
    """At H = 8192 even 8 units' rows (512 KiB) exceed a block's shared
    memory, whatever the SM count."""
    assert persistent_plan(1, 8192, torch.bfloat16, sms) is None
    assert persistent_plan(2, 8192, torch.bfloat16, sms) is None


def test_the_rule_on_114_sms():
    """An H100 PCIe: the bi-LSTM at H = 1024 would need 128 blocks of 16
    units (too many) or 32 units a block (256 KiB of W_hh, too much), so it
    keeps the per-step grids; D = 1 takes 16 units on 64 blocks."""
    assert persistent_plan(2, 1024, torch.bfloat16, H100_PCIE_SMS) is None
    assert persistent_plan(1, 1024, torch.bfloat16, H100_PCIE_SMS)[:2] == (
        16, 64)


@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("sms", [1, 4, 33, H100_PCIE_SMS, H100_SXM_SMS, 500])
def test_plans_fit_the_card(directions, sms):
    """Every plan: units in 8, 16, 32, 64 dividing H, one block an SM at
    most, shared memory within 232,448 bytes, and the smallest units that
    fit."""
    for hidden in range(16, 4097, 16):
        plan = persistent_plan(directions, hidden, torch.bfloat16, sms)
        if plan is None:
            continue
        units, blocks, smem = plan
        assert units in (8, 16, 32, 64) and hidden % units == 0
        assert blocks == directions * hidden // units <= sms
        assert smem == persistent_smem_bytes(units, hidden) <= SMEM_PER_BLOCK
        for smaller in (8, 16, 32):
            if smaller < units and hidden % smaller == 0:
                assert (directions * hidden // smaller > sms
                        or persistent_smem_bytes(smaller, hidden)
                        > SMEM_PER_BLOCK)


def test_small_hidden_sizes_have_plans():
    """The card tests' widths all take the persistent kernel on an H100."""
    for hidden in (16, 48, 272, 1024):
        for directions in (1, 2):
            assert persistent_plan(directions, hidden, torch.bfloat16,
                                   H100_SXM_SMS) is not None


def test_mirror_matches_the_cuda_source():
    """``persistent_smem_bytes`` repeats the layout constants of the CUDA
    source's ``namespace persistent``; the C entry refuses a plan whose
    bytes differ, so a drift would raise on the card."""
    with open(SOURCE) as fd:
        source = fd.read()
    body = source[source.index("namespace persistent {"):]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", body))
    assert int(consts["kWarps"]) == lstm_cuda._WARPS
    assert 16 * int(consts["kMaxTiles"]) == lstm_cuda._ROWS
    assert int(consts["kChunk"]) == lstm_cuda._CHUNK
    assert int(consts["kStages"]) == lstm_cuda._STAGES
    assert int(consts["kPad"]) == lstm_cuda._PAD
    # The formula of the source, term by term, at the main shape.
    units, hidden = 16, 1024
    expected = (4 * units * (hidden + lstm_cuda._PAD) * 2
                + (lstm_cuda._WARPS * 8 // units) * lstm_cuda._STAGES
                * lstm_cuda._ROWS * (lstm_cuda._CHUNK + lstm_cuda._PAD) * 2)
    assert persistent_smem_bytes(units, hidden) == expected


def test_cpu_tensors_never_reach_the_kernels():
    """The wrappers take CUDA tensors only; on the CPU the model runs the
    plain versions (``LstmRecurrence`` picks them by device)."""
    args = (torch.zeros(2, 3, 4, 64, dtype=torch.bfloat16),
            torch.zeros(2, 64, 16, dtype=torch.bfloat16),
            torch.ones(4, dtype=torch.int32))
    for run in (lstm_cuda.lstm_recurrence_cuda,
                lstm_cuda.lstm_recurrence_save_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            run(*args)
