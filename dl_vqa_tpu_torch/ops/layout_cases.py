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
"""

from __future__ import annotations

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["MODES", "layout_case_reference", "layout_case_cuda",
           "layout_case"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODES = ("split", "merge", "strided", "shift")


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


def layout_case_cuda(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Kernel 9 on ``x``'s CUDA device; raises on any input it does not
    take."""
    mode = _mode_index(mode)
    _check(x, mode)
    if not x.is_cuda:
        raise ValueError(f"layout_case_cuda takes a CUDA tensor; got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be one of {list(_DTYPES)}; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows, width, channels = x.shape
    if channels * x.element_size() % 16:
        raise ValueError(f"kernel 9 moves 16-byte vectors: C must be a "
                         f"multiple of {16 // x.element_size()}; got "
                         f"{channels}")
    shape = {0: (rows, width // 2, channels),
             1: (rows, width // 2, 2 * channels),
             2: (rows, width // 2, channels),
             3: (rows, width, channels)}[mode]
    lib = _native.library()
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    code = lib.vqa_layout_case(
        x.data_ptr(), out.data_ptr(), rows, width, channels, mode,
        _DTYPES[x.dtype], _native.stream_ptr(x.device))
    _native.check("layout_case", code)
    if out.numel():  # the C entry launches nothing for no output
        layout_case_cuda.launches += 1
    return out


layout_case_cuda.launches = 0


def layout_case(x: torch.Tensor, mode: str,
                plain: bool = False) -> torch.Tensor:
    """Dispatch: a CPU tensor, or ``plain=True``, runs the plain version;
    any other device runs kernel 9, which raises where it cannot launch."""
    if plain or x.device.type == "cpu":
        return layout_case_reference(x, mode)
    return layout_case_cuda(x, mode)
