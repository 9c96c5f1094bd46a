"""Kernel 1: the masked LSTM recurrence on Hopper (``csrc/lstm_recurrence.cu``).

Replaces ``dl_vqa_tpu/ops/lstm_pallas.py::_lstm_kernel`` (non-save mode of
``_lstm_scan_pallas_impl``). Its plain PyTorch version is
:func:`dl_vqa_tpu_torch.ops.lstm.lstm_recurrence_reference`.

What bounds it on this card: the recurrence is serial in T, and each step
is a ``[B, H] x [H, 4H]`` product against all of W_hh (8 MB per direction
in bf16). The TPU kernel kept W_hh in VMEM across one sequential grid; an
SM holds 227 KB, so here W_hh stays in the 50 MB L2 between the T
launches (one per step, both directions in each launch), and every block
re-reads its 16 rows of each gate from L2 (for 64 batch rows at once
when the batch exceeds 64). The product (~4.3 GFLOP a step per direction
at batch 512) runs on the tensor cores (wmma, bf16 in, f32 accumulate).
Every block also reads all of h, so each step writes h rounded to bf16
beside the f32 h for the next step to stage. At serving batches of 1 to
64 the per-step launches and the L2 latency of W_hh dominate; a
persistent kernel or a CUDA graph is the next step. h is double-buffered
between launches; c is updated in place, one owner per element.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["lstm_recurrence_cuda"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_UNITS = 16  # hidden units per block (csrc/lstm_recurrence.cu kUnits)


def lstm_recurrence_cuda(
    x_proj: torch.Tensor,     # [D, T, B, 4H], bf16 or f32
    weight_hh: torch.Tensor,  # [D, 4H, H], same dtype
    lengths: torch.Tensor,    # [B] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final f32 ``(h, c)``, each ``[D, B, H]``, computed by the CUDA
    kernel on ``x_proj``'s device. Raises on any input it does not take."""
    if x_proj.dim() != 4 or weight_hh.dim() != 3 or lengths.dim() != 1:
        raise ValueError(
            f"expected x_proj [D,T,B,4H], weight_hh [D,4H,H], lengths [B]; "
            f"got {tuple(x_proj.shape)}, {tuple(weight_hh.shape)}, "
            f"{tuple(lengths.shape)}")
    directions, seq_len, batch, four_h = x_proj.shape
    hidden = weight_hh.shape[-1]
    if (four_h != 4 * hidden
            or tuple(weight_hh.shape) != (directions, 4 * hidden, hidden)
            or lengths.shape[0] != batch):
        raise ValueError(
            f"shape mismatch: x_proj {tuple(x_proj.shape)}, weight_hh "
            f"{tuple(weight_hh.shape)}, lengths {tuple(lengths.shape)}")
    if hidden % _UNITS:
        raise ValueError(f"hidden size {hidden} is not a multiple of {_UNITS}")
    for name, t in (("x_proj", x_proj), ("weight_hh", weight_hh),
                    ("lengths", lengths)):
        if not t.is_cuda or t.device != x_proj.device:
            raise ValueError(f"{name} must be a CUDA tensor on one device; "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x_proj.dtype not in _DTYPES or weight_hh.dtype != x_proj.dtype:
        raise ValueError(
            f"x_proj and weight_hh must share a dtype in {list(_DTYPES)}; "
            f"got {x_proj.dtype}, {weight_hh.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    if weight_hh.data_ptr() % 32:
        raise ValueError("weight_hh must be 32-byte aligned")

    lib = _native.library()
    h = torch.zeros(2, directions, batch, hidden, dtype=torch.float32,
                    device=x_proj.device)
    c = torch.zeros(directions, batch, hidden, dtype=torch.float32,
                    device=x_proj.device)
    # h rounded to the weight dtype, double-buffered like h; f32 uses h.
    hq = h if x_proj.dtype == torch.float32 else torch.zeros(
        2, directions, batch, hidden, dtype=x_proj.dtype, device=x_proj.device)
    code = lib.vqa_lstm_recurrence(
        x_proj.data_ptr(), weight_hh.data_ptr(), lengths.data_ptr(),
        h[0].data_ptr(), h[1].data_ptr(), hq[0].data_ptr(), hq[1].data_ptr(),
        c.data_ptr(), directions, seq_len, batch, hidden,
        _DTYPES[x_proj.dtype], _native.stream_ptr(x_proj.device))
    _native.check("lstm_recurrence", code)
    # The C entry launches one grid per timestep (none for an empty batch).
    if batch and directions:
        lstm_recurrence_cuda.launches += seq_len
    return h[seq_len % 2], c


lstm_recurrence_cuda.launches = 0
