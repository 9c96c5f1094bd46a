"""The four layout cases of ``experiments/probe_mosaic_recheck.py``.

That probe asks the TPU's kernel compiler whether it can lower four
re-layouts of a ``[16, 32, C]`` bf16 block (C = 64 and 128), because the
conv0 pooling of the JAX package was shaped by what it could not. Kernel 9
(``csrc/layout_cases.cu``) computes the same four functions; on this card
they are index arithmetic, and the kernel stands as the record of that. No
model of either package calls them.

``mode`` is ``"split"``: ``v.reshape(R, W/2, 2, C).max(2)``; ``"merge"``:
``v.reshape(R, W/2, 2C)``; ``"strided"``: ``max(v[:, 0::2], v[:, 1::2])``;
or ``"shift"``: ``cat(v[:, 1:], v[:, :1], 1)`` (the kernel's modes 0 to 3).
Moves and a max: the kernel and the plain version agree to the bit.
:func:`layout_cases` runs several cases (the probe's eight) in one launch.
"""

from __future__ import annotations

import functools
import struct
from typing import List, Sequence

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["MODES", "MAX_CASES", "THREADS", "layout_case_reference",
           "layout_case_cuda", "layout_case", "layout_cases_reference",
           "layout_cases_cuda", "layout_cases", "output_shape",
           "batched_plan", "batched_vectors"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = ("split", "merge", "strided", "shift")
# csrc/layout_cases.cu: threads a block (kThreads), cases a launch of the
# batched entry (kMaxCases).
THREADS = 256
MAX_CASES = 8


def _mode_index(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    return MODES.index(mode)


def _check(x: torch.Tensor, mode: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected x [R, W, C]; got {tuple(x.shape)}")
    if mode != 3 and x.shape[1] % 2:
        raise ValueError(f"mode {MODES[mode]!r} pairs columns: W must be "
                         f"even; got {x.shape[1]}")


def output_shape(shape: Sequence[int], mode: str) -> tuple:
    """``[R, W, C]`` -> the shape ``mode`` makes of it."""
    rows, width, channels = shape
    if mode == "shift":
        return (rows, width, channels)
    if mode == "merge":
        return (rows, width // 2, 2 * channels)
    return (rows, width // 2, channels)


def layout_case_reference(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of kernel 9, in the probe's own expressions."""
    mode = _mode_index(mode)
    _check(x, mode)
    rows, width, channels = x.shape
    if mode == 0:
        return x.reshape(rows, width // 2, 2, channels).amax(dim=2)
    if mode == 1:
        return x.reshape(rows, width // 2, 2 * channels).clone()
    if mode == 2:
        return torch.maximum(x[:, 0::2], x[:, 1::2])
    return torch.cat([x[:, 1:], x[:, :1]], dim=1)


def _check_cuda(x: torch.Tensor, mode: str) -> int:
    """Raise on any case kernel 9 does not take; returns the mode's code."""
    index = _mode_index(mode)
    _check(x, index)
    if not x.is_cuda:
        raise ValueError(f"kernel 9 takes a CUDA tensor; got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be one of {list(_DTYPES)}; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[2] * x.element_size() % 16:
        raise ValueError(f"kernel 9 moves 16-byte vectors: C must be a "
                         f"multiple of {16 // x.element_size()}; got "
                         f"{x.shape[2]}")
    return index


@functools.cache
def _cases_entry():
    """The C entry ``vqa_layout_cases``, looked up once."""
    return _native.library().vqa_layout_cases


def layout_case_cuda(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Kernel 9 on ``x``'s CUDA device: one case, a batch of one of
    :func:`layout_cases_cuda` (whose ``launches`` counts it); raises on any
    input it does not take."""
    return layout_cases_cuda([x], [mode])[0]


def layout_case(x: torch.Tensor, mode: str,
                plain: bool = False) -> torch.Tensor:
    """Dispatch: a CPU tensor, or ``plain=True``, runs the plain version;
    any other device runs kernel 9, which raises where it cannot launch."""
    if plain or x.device.type == "cpu":
        return layout_case_reference(x, mode)
    return layout_case_cuda(x, mode)


def batched_plan(shapes: Sequence[Sequence[int]], modes: Sequence[str],
                 dtypes: Sequence[torch.dtype]) -> List[dict]:
    """The batched entry's grid, as ``vqa_layout_cases`` lays it: for each
    case its output vectors (16 bytes each), its first block and its block
    count, the cases' blocks one after another in the order given."""
    plan, first = [], 0
    for shape, mode, dtype in zip(shapes, modes, dtypes):
        out = output_shape(shape, mode)
        vectors = out[0] * out[1] * out[2] * dtype.itemsize // 16
        blocks = -(-vectors // THREADS)
        plan.append({"vectors": vectors, "first_block": first,
                     "blocks": blocks})
        first += blocks
    return plan


def batched_vectors(plan: List[dict], block: int) -> List[tuple]:
    """``(case, output vector)`` that each thread of ``block`` makes, as the
    kernel picks its case (the last one whose first block is at or before
    this one) and masks the ragged end; None where a thread makes none."""
    case = 0
    for k in range(1, len(plan)):
        if block >= plan[k]["first_block"]:
            case = k
    first = (block - plan[case]["first_block"]) * THREADS
    return [(case, first + thread)
            if first + thread < plan[case]["vectors"] else None
            for thread in range(THREADS)]


def layout_cases_reference(xs: Sequence[torch.Tensor],
                           modes: Sequence[str]) -> List[torch.Tensor]:
    """Plain version of the batched kernel: each case on its own."""
    return [layout_case_reference(x, mode) for x, mode in zip(xs, modes)]


def layout_cases_cuda(xs: Sequence[torch.Tensor],
                      modes: Sequence[str]) -> List[torch.Tensor]:
    """Kernel 9 on up to :data:`MAX_CASES` cases in one launch, every case
    on one CUDA device; ``launches`` counts its grids (one a call with any
    output). Raises on any case it does not take."""
    if len(xs) != len(modes) or not 0 < len(xs) <= MAX_CASES:
        raise ValueError(f"expected 1 to {MAX_CASES} cases, a mode each; got "
                         f"{len(xs)} tensors and {len(modes)} modes")
    outs, desc = [], []
    for x, mode in zip(xs, modes):
        index = _check_cuda(x, mode)
        if x.device != xs[0].device:
            raise ValueError(f"every case must lie on {xs[0].device}; got "
                             f"{x.device}")
        out = torch.empty(output_shape(x.shape, mode), dtype=x.dtype,
                          device=x.device)
        outs.append(out)
        desc += [x.data_ptr(), out.data_ptr(), *x.shape, index,
                 _DTYPES[x.dtype]]
    # The descriptors as packed int64 (a ctypes array takes ten times as
    # long to build).
    code = _cases_entry()(
        struct.pack(f"{len(desc)}q", *desc), len(xs),
        _native.stream_ptr(xs[0].device))
    _native.check("layout_cases", code)
    if any(out.numel() for out in outs):
        layout_cases_cuda.launches += 1
    return outs


layout_cases_cuda.launches = 0


def layout_cases(xs: Sequence[torch.Tensor], modes: Sequence[str],
                 plain: bool = False) -> List[torch.Tensor]:
    """Dispatch of the batched cases: CPU tensors, or ``plain=True``, run
    the plain version; CUDA tensors the one launch of kernel 9."""
    if plain or all(x.device.type == "cpu" for x in xs):
        return layout_cases_reference(xs, modes)
    return layout_cases_cuda(xs, modes)
