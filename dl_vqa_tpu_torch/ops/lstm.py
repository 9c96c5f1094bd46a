"""Variable-length (bi-)LSTM for the port: masked recurrence, final state.

Port of :mod:`dl_vqa_tpu.ops.lstm` (the functions the serving forward
runs). Packed-sequence semantics, as there: the forward direction's state
after tokens ``0 .. len-1``; the backward direction is a forward scan over
the reversed valid prefix; pad positions never touch the state.

The input projection ``x @ W_ih + b`` for every timestep is one matmul
outside the recurrence, stored time-major in ``x``'s dtype, as
``dl_vqa_tpu/ops/lstm_pallas.py`` does it. The recurrence itself goes to
:func:`lstm_recurrence`: its plain PyTorch version for a tensor on the
CPU, kernel 1 (:mod:`dl_vqa_tpu_torch.ops.lstm_cuda`) for a CUDA tensor.

Weights are in torch layout: ``weight_ih [4H, E]``, ``weight_hh [4H, H]``
and the fused ``bias [4H]`` (``bias_ih + bias_hh``); gate order i, f, g, o.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

__all__ = [
    "lstm_cell",
    "lstm_recurrence_reference",
    "lstm_recurrence",
    "input_projection",
    "lstm_scan",
    "reverse_valid_prefix",
    "bilstm_final_cell",
]

Recurrence = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                      Tuple[torch.Tensor, torch.Tensor]]


def _cell(x_proj, h, c, w_t, w_dtype):
    # h is rounded to the weight dtype; the product and the sum are f32.
    gates = x_proj.float() + torch.matmul(h.to(w_dtype).float(), w_t)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell(x_proj: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              weight_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step, torch gate order: ``x_proj [..., 4H]``, f32 ``h``, ``c``
    ``[..., H]``, ``weight_hh [..., 4H, H]`` -> f32 ``(h', c')``."""
    return _cell(x_proj, h, c, weight_hh.float().transpose(-1, -2),
                 weight_hh.dtype)


def lstm_recurrence_reference(
    x_proj: torch.Tensor,     # [D, T, B, 4H]
    weight_hh: torch.Tensor,  # [D, 4H, H]
    lengths: torch.Tensor,    # [B] int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1: the masked recurrence over T for
    D independent directions; returns the final f32 ``(h, c)``, each
    ``[D, B, H]``. Where ``t >= len`` the carry passes through."""
    directions, seq_len, batch, _ = x_proj.shape
    hidden = weight_hh.shape[-1]
    h = torch.zeros(directions, batch, hidden, dtype=torch.float32,
                    device=x_proj.device)
    c = torch.zeros_like(h)
    w_t = weight_hh.float().transpose(-1, -2)
    steps = torch.arange(seq_len, device=lengths.device)
    keep_all = steps[:, None] < lengths[None, :]  # [T, B]
    for t in range(seq_len):
        h_new, c_new = _cell(x_proj[:, t], h, c, w_t, weight_hh.dtype)
        keep = keep_all[t][None, :, None]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
    return h, c


def lstm_recurrence(x_proj: torch.Tensor, weight_hh: torch.Tensor,
                    lengths: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch: a CPU tensor runs :func:`lstm_recurrence_reference`; any
    other device runs kernel 1, which raises where it cannot launch."""
    if x_proj.device.type == "cpu":
        return lstm_recurrence_reference(x_proj, weight_hh, lengths)
    from dl_vqa_tpu_torch.ops.lstm_cuda import lstm_recurrence_cuda

    return lstm_recurrence_cuda(x_proj, weight_hh, lengths.to(torch.int32))


def input_projection(x: torch.Tensor, params: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """``x [B, T, E]`` -> time-major ``x @ W_ih^T + b`` ``[T, B, 4H]`` in
    ``x``'s dtype. The product runs in f32, as ``jnp.dot`` of a bf16 input
    and the f32 weight does in the JAX package."""
    proj = torch.matmul(x.float(), params["weight_ih"].float().t())
    return (proj + params["bias"].float()).to(x.dtype).transpose(0, 1)


def lstm_scan(x: torch.Tensor, lengths: torch.Tensor,
              params: Dict[str, torch.Tensor],
              recurrence: Recurrence = lstm_recurrence
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked forward LSTM over ``x [B, T, E]``; final f32 ``(h, c)``,
    each ``[B, H]`` (the state at step ``len - 1``)."""
    x_proj = input_projection(x, params).unsqueeze(0).contiguous()
    w_hh = params["weight_hh"].to(x.dtype).unsqueeze(0).contiguous()
    h, c = recurrence(x_proj, w_hh, lengths)
    return h[0], c[0]


def reverse_valid_prefix(x: torch.Tensor, lengths: torch.Tensor
                         ) -> torch.Tensor:
    """``x [B, T, E]``: ``out[b, t] = x[b, len_b - 1 - t]`` for ``t <
    len_b``; later positions hold clamped copies that the masked scan
    never reads."""
    seq_len = x.shape[1]
    t = torch.arange(seq_len, device=x.device)
    src = (lengths.to(x.device, torch.int64)[:, None] - 1 - t[None, :])
    src = src.clamp(0, seq_len - 1)
    return torch.gather(x, 1, src[:, :, None].expand_as(x))


def bilstm_final_cell(x: torch.Tensor, lengths: torch.Tensor,
                      fwd_params: Dict[str, torch.Tensor],
                      bwd_params: Dict[str, torch.Tensor],
                      recurrence: Recurrence = lstm_recurrence
                      ) -> torch.Tensor:
    """Final cell states of both directions, ``[c_fwd, c_bwd]`` ->
    ``[B, 2H]`` f32. Both directions run in one recurrence (``D = 2``)."""
    x_proj = torch.stack([
        input_projection(x, fwd_params),
        input_projection(reverse_valid_prefix(x, lengths), bwd_params),
    ])
    w_hh = torch.stack([fwd_params["weight_hh"].to(x.dtype),
                        bwd_params["weight_hh"].to(x.dtype)])
    _, c = recurrence(x_proj, w_hh, lengths)
    return torch.cat([c[0], c[1]], dim=-1)
