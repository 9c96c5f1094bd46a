"""Kernels C and 7's dispatch rules, work split and weight packing, on the
CPU.

Kernel C (``csrc/relu_maxpool_backward.cu``) runs a vector kernel where
``ops/conv_fused.py::pool_backward_vector_path`` says so: the model's three
conv outputs take it, the card tests' other channel counts and any tensor
off a 16-byte boundary keep the scalar kernel. The mirror of the vector
kernel's work split writes every element of ``dz`` exactly once, the odd
last row and column included, and a thread's channel vector never changes
across its grid-stride steps. Kernel 7 (``csrc/conv_relu_pool_stem.cu``)
runs on the tensor cores where ``stem_mma_path`` says so; its packed
weight puts every value of the padded ``[K_pad, Cout]`` matrix once where
mma's B fragments read it, and ``stem_mma_emulation``, its arithmetic in
plain PyTorch, equals the plain version (``tests/test_torch_fused.py``
holds it to the JAX Pallas stem as well). The mirrors' constants are read
from the CUDA sources. The card tests hold the C entries to the mirrors.
"""

import os
import re

import numpy as np
import pytest
import torch

from dl_vqa_tpu_torch.ops import conv_fused
from dl_vqa_tpu_torch.ops.conv_fused import (
    POOL_BACKWARD_MAX_PIXELS,
    POOL_BACKWARD_THREADS,
    POOL_BACKWARD_VECTOR_BYTES,
    STEM_MAX_KSTEPS,
    STEM_MAX_ROW_TAPS,
    conv_relu_pool_stem_reference,
    pack_stem_weight,
    pool_backward_vector_path,
    pool_backward_vector_split,
    pool_backward_vector_stores,
    stem_k_offsets,
    stem_mma_emulation,
    stem_mma_path,
)

CSRC = os.path.join(os.path.dirname(conv_fused.__file__), os.pardir, "csrc")
# The model's conv outputs at B = 512: Hc = Wc, C.
CONV_OUTPUTS = [(222, 64), (109, 128), (52, 256)]
VECTOR_CHANNELS = [8, 16, 64, 128, 256]
SCALAR_CHANNELS = [1, 3, 12, 200, 300]
DTYPES = [torch.bfloat16, torch.float32]


def _source(name):
    with open(os.path.join(CSRC, name)) as fd:
        return fd.read()


def _constant(source, name):
    found = re.search(rf"constexpr \w+ {name} = ([^;]+);", source)
    assert found, name
    return found.group(1).strip()


# ----------------------------------------------------------------- kernel C

def test_pool_backward_mirror_matches_the_source():
    source = _source("relu_maxpool_backward.cu")
    assert int(_constant(source, "kThreads")) == POOL_BACKWARD_THREADS
    assert int(_constant(source, "kVectorBytes")) == \
        POOL_BACKWARD_VECTOR_BYTES
    assert _constant(source, "kMaxVectorPixels") == "int64_t{1} << 31"
    assert POOL_BACKWARD_MAX_PIXELS == 1 << 31
    # The rule's clauses, as the C function states them.
    rule = source[source.index("bool vector_path("):]
    rule = rule[:rule.index("}")]
    for clause in ("channels % vec == 0",
                   "kThreads % (channels / vec) == 0",
                   "pixels < kMaxVectorPixels", "aligned(g)", "aligned(y)",
                   "aligned(bias)", "aligned(dz)"):
        assert clause in rule, clause


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size,channels", CONV_OUTPUTS)
def test_the_model_conv_outputs_take_the_vector_kernel(dtype, size,
                                                       channels):
    assert pool_backward_vector_path(512, size, size, channels, dtype,
                                     (0, 256, 1024, 4096))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("channels", VECTOR_CHANNELS + SCALAR_CHANNELS)
def test_the_vector_rule_by_channel_count(dtype, channels):
    """8, 16, 64, 128 and 256 channels are whole vectors whose count
    divides 256 threads; 1, 3, 12, 200 and 300 are not (200 bf16 channels
    are 25 vectors)."""
    assert pool_backward_vector_path(8, 9, 7, channels, dtype) == (
        channels in VECTOR_CHANNELS)


@pytest.mark.parametrize("offset", [2, 4, 8])
@pytest.mark.parametrize("which", range(4))
def test_a_pointer_off_a_16_byte_boundary_takes_the_scalar_kernel(offset,
                                                                  which):
    pointers = [4096] * 4
    pointers[which] += offset
    assert pool_backward_vector_path(8, 10, 10, 64, torch.bfloat16,
                                     tuple(pointers)) is False
    assert pool_backward_vector_path(8, 10, 10, 64, torch.bfloat16,
                                     (4096,) * 4)


def test_too_many_pooled_pixels_take_the_scalar_kernel():
    assert not pool_backward_vector_path(1 << 13, 1 << 10, 1 << 10, 8,
                                         torch.bfloat16)
    assert pool_backward_vector_path(1, 1 << 10, 1 << 10, 8, torch.bfloat16)
    assert not pool_backward_vector_path(1, 4, 4, 8, torch.float16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,hc,wc,channels,blocks", [
    (2, 9, 7, 64, 3),      # odd last row and column
    (1, 6, 11, 8, 1),      # one block, odd last column
    (3, 7, 6, 16, 4),      # odd last row
    (2, 5, 5, 256, 2),     # a vector's lanes span warps
    (1, 4, 4, 128, 5),     # more blocks than a step needs
    (67, 3, 3, 8, 7),      # one window an image
])
def test_the_vector_split_writes_every_element_once(dtype, batch, hc, wc,
                                                    channels, blocks):
    """The 16-byte stores of all threads' windows cover ``dz`` exactly, and
    each thread keeps one channel vector across its grid-stride steps."""
    vec = POOL_BACKWARD_VECTOR_BYTES // dtype.itemsize
    assert pool_backward_vector_path(batch, hc, wc, channels, dtype)
    written = np.zeros(batch * hc * wc * channels, dtype=np.int64)
    windows = 0
    split = pool_backward_vector_split(batch, hc, wc, channels, dtype,
                                       blocks)
    assert len(split) == blocks * POOL_BACKWARD_THREADS
    for (_, thread), items in split.items():
        assert len({ch for _, ch in items}) <= 1
        for p, ch in items:
            assert ch == thread % (channels // vec) * vec
            windows += 1
            for offset in pool_backward_vector_stores(p, ch, hc, wc,
                                                      channels):
                assert offset % vec == 0
                written[offset:offset + vec] += 1
    assert windows == batch * (hc // 2) * (wc // 2) * (channels // vec)
    assert written.min() == written.max() == 1


# ----------------------------------------------------------------- kernel 7

def test_stem_mirror_matches_the_source():
    source = _source("conv_relu_pool_stem.cu")
    assert int(_constant(source, "kStemMaxKSteps")) == STEM_MAX_KSTEPS
    assert int(_constant(source, "kStemMaxRowTaps")) == STEM_MAX_ROW_TAPS
    rule = source[source.index("bool stem_mma_plan("):]
    rule = rule[:rule.index("p->nt =")]
    for clause in ("dtype != vqa::kBFloat16", "cout % 8",
                   "(kk + 15) / 16", "p->ksteps > kStemMaxKSteps",
                   "k * cin > kStemMaxRowTaps"):
        assert clause in rule, clause


@pytest.mark.parametrize("dtype,cin,cout,k,takes", [
    (torch.bfloat16, 3, 64, 3, True),    # the RGB stem: K 27 -> 32
    (torch.bfloat16, 3, 8, 5, True),     # chip_smoke's k = 5 case: 75 -> 80
    (torch.bfloat16, 1, 16, 9, True),    # 81 -> 96, the largest K
    (torch.bfloat16, 4, 40, 2, True),    # 16, one k step
    (torch.bfloat16, 4, 8, 5, False),    # 100 -> 112
    (torch.bfloat16, 16, 64, 3, False),  # 144
    (torch.bfloat16, 16, 64, 1, True),   # K 16, a filter row of 16 taps
    (torch.bfloat16, 32, 64, 1, False),  # K 32, but a row of 32 taps
    (torch.bfloat16, 24, 8, 2, False),   # K 96, a row of 48 taps
    (torch.bfloat16, 3, 12, 3, False),   # Cout no multiple of 8
    (torch.float32, 3, 64, 3, False),    # f32 stays on the FMA units
])
def test_the_stem_rule(dtype, cin, cout, k, takes):
    assert stem_mma_path(dtype, cin, cout, k) is takes


@pytest.mark.parametrize("cin,cout,k", [(3, 64, 3), (3, 8, 5), (1, 16, 9),
                                        (4, 40, 2), (3, 128, 3)])
def test_packed_stem_weight_holds_each_value_once(cin, cout, k):
    """Every value of the ``[K_pad, Cout]`` matrix, K ordered (di, dj, ci),
    lies once in the packed weight, at lane ``4 (n % 8) + (k % 16 % 8) /
    2`` of k step ``k / 16`` and tile ``n / 8``, register ``k % 16 / 8``,
    half ``k % 2``; the padding rows are zero."""
    gen = torch.Generator().manual_seed(cin * 100 + cout + k)
    # Distinct bf16-exact values, so that each one can be found.
    taps = k * k * cin
    values = torch.randperm(taps * cout, generator=gen).float() + 1
    weight = values.reshape(k, k, cin, cout).permute(3, 2, 0, 1)
    packed = pack_stem_weight(weight)
    ksteps = -(-taps // 16)
    assert packed.shape == (ksteps, cout // 8, 32, 4)
    assert packed.dtype == torch.bfloat16
    matrix = weight.permute(2, 3, 1, 0).reshape(taps, cout)
    exact = matrix.bfloat16()
    seen = 0
    for kk in range(16 * ksteps):
        for n in range(cout):
            lane = 4 * (n % 8) + (kk % 16 % 8) // 2
            got = packed[kk // 16, n // 8, lane, 2 * (kk % 16 // 8) + kk % 2]
            if kk < taps:
                assert got == exact[kk, n], (kk, n)
                seen += 1
            else:
                assert got == 0
    assert seen == taps * cout


@pytest.mark.parametrize("k,cin,row_values", [(3, 3, 102), (5, 3, 108),
                                              (2, 4, 136)])
def test_stem_offsets_walk_each_filter_row_as_one_run(k, cin, row_values):
    offsets = stem_k_offsets(k, cin, row_values)
    taps = k * k * cin
    assert offsets.numel() % 16 == 0 and offsets.numel() - taps < 16
    for kk in range(taps):
        di, rest = divmod(kk, k * cin)
        assert offsets[kk] == di * row_values + rest
    assert bool((offsets[taps:] == -1).all())


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", [1, 3, 4])
@pytest.mark.parametrize("cout", [8, 64])
def test_stem_emulation_matches_the_plain_version_in_bf16(k, cin, cout):
    """The tensor cores' arithmetic (bf16 operands, f32 sums in another
    order, one rounding) against the plain version: at most one bf16 step
    of the element apart, and few elements differ at all. (k = 5 with 4
    channels, K = 100, is past what the kernel takes; the arithmetic is
    the same.)"""
    gen = torch.Generator().manual_seed(31 * k + cin + cout)
    x = torch.randn(2, 23, 26, cin, generator=gen).bfloat16()
    weight = torch.randn(cout, cin, k, k, generator=gen) / (cin * k * k) ** .5
    bias = torch.randn(cout, generator=gen) * 0.1
    got = stem_mma_emulation(x, pack_stem_weight(weight), bias, k)
    want = conv_relu_pool_stem_reference(x, weight, bias)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <=
                 2.0 ** -7 * want.abs().clamp(min=1e-3)).all())
    assert float((got != want).float().mean()) < 0.02
