"""Variable-length (bi-)LSTM for the port: masked recurrence, final state,
and its gradient from saved states.

Port of :mod:`dl_vqa_tpu.ops.lstm` and of the differentiable scan of
``dl_vqa_tpu/ops/lstm_pallas.py``. Packed-sequence semantics, as there:
the forward direction's state after tokens ``0 .. len-1``; the backward
direction is a forward scan over the reversed valid prefix; pad positions
never touch the state.

The input projection ``x @ W_ih + b`` for every timestep and direction is
one batched matmul outside the recurrence, time-major. The recurrence is
:class:`LstmRecurrence`, an ``autograd.Function`` over ``(x_proj,
weight_hh, lengths)``:

* no gradient asked: kernel 1 (``csrc/lstm_recurrence.cu``), final
  ``(h, c)`` only;
* gradient asked: kernel A, the same step that also writes the f32
  pre-activation gates and the masked carries of every step (the port of
  ``_lstm_kernel_save``); the backward is ``_lstm_saved_state_bwd``: a
  reverse loop of kernel B (``csrc/lstm_backward.cu``, the elementwise
  step) and one ``[B, 4H] x [4H, H]`` product per step, then one large
  product for ``dW_hh``. As there, the backward multiplies by the f32
  master ``W_hh`` and the f32 carries, not by the rounded copies the
  forward used, and hands ``x_proj`` its f32 cotangent straight through
  the cast to the compute dtype.

A tensor on the CPU, or ``plain=True``, runs each kernel's plain PyTorch
version, which stands beside it here.

Weights are in torch layout: ``weight_ih [4H, E]``, ``weight_hh [4H, H]``
and the fused ``bias [4H]`` (``bias_ih + bias_hh``); gate order i, f, g, o.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

__all__ = [
    "lstm_cell",
    "lstm_recurrence_reference",
    "lstm_recurrence_save_reference",
    "lstm_backward_step_reference",
    "lstm_saved_state_backward",
    "LstmRecurrence",
    "lstm_recurrence_grad",
    "input_projections",
    "lstm_scan",
    "reverse_valid_prefix",
    "bilstm_final_cell",
]


def _cell(x_proj, h, c, w_t, w_dtype):
    # h is rounded to the weight dtype; the product and the sum are f32.
    gates = x_proj.float() + torch.matmul(h.to(w_dtype).float(), w_t)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new, gates


def lstm_cell(x_proj: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              weight_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step, torch gate order: ``x_proj [..., 4H]``, f32 ``h``, ``c``
    ``[..., H]``, ``weight_hh [..., 4H, H]`` -> f32 ``(h', c')``."""
    return _cell(x_proj, h, c, weight_hh.float().transpose(-1, -2),
                 weight_hh.dtype)[:2]


def _recurrence(x_proj, weight_hh, lengths, save):
    directions, seq_len, batch, _ = x_proj.shape
    hidden = weight_hh.shape[-1]
    h = torch.zeros(directions, batch, hidden, dtype=torch.float32,
                    device=x_proj.device)
    c = torch.zeros_like(h)
    w_t = weight_hh.float().transpose(-1, -2)
    steps = torch.arange(seq_len, device=lengths.device)
    keep_all = steps[:, None] < lengths[None, :]  # [T, B]
    saved = ([], [], [])
    for t in range(seq_len):
        h_new, c_new, gates = _cell(x_proj[:, t], h, c, w_t, weight_hh.dtype)
        keep = keep_all[t][None, :, None]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
        if save:
            for seq, value in zip(saved, (gates, c, h)):
                seq.append(value)
    if not save:
        return h, c
    if not seq_len:
        shape = (directions, 0, batch)
        return (h, c, h.new_zeros(*shape, 4 * hidden),
                h.new_zeros(*shape, hidden), h.new_zeros(*shape, hidden))
    return (h, c) + tuple(torch.stack(seq, dim=1) for seq in saved)


def lstm_recurrence_reference(
    x_proj: torch.Tensor,     # [D, T, B, 4H]
    weight_hh: torch.Tensor,  # [D, 4H, H]
    lengths: torch.Tensor,    # [B] int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1: the masked recurrence over T for
    D independent directions; returns the final f32 ``(h, c)``, each
    ``[D, B, H]``. Where ``t >= len`` the carry passes through."""
    return _recurrence(x_proj, weight_hh, lengths, save=False)


def lstm_recurrence_save_reference(
    x_proj: torch.Tensor, weight_hh: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Plain version of kernel A: ``(h, c, gates_all [D, T, B, 4H], c_all,
    h_all [D, T, B, H])``, all f32. ``gates_all[t]`` are the
    pre-activation gates of step t (also at a padded step); ``c_all[t]``,
    ``h_all[t]`` the carries after step t's masked update."""
    return _recurrence(x_proj, weight_hh, lengths, save=True)


def lstm_backward_step_reference(
    gates: torch.Tensor,    # [D, B, 4H] f32, step t's pre-activation gates
    c_t: torch.Tensor,      # [D, B, H] f32, carry after step t
    c_prev: torch.Tensor,   # [D, B, H] f32, carry before step t
    keep: torch.Tensor,     # [B] bool, t < len
    dh: torch.Tensor,       # [D, B, H] f32
    dc: torch.Tensor,       # [D, B, H] f32
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel B, the elementwise part of one reverse
    step: ``(dgates [D, B, 4H], dh_pass, dc_prev)``. ``dh_pass`` is the
    part of ``dh`` that passes a padded step; the caller adds ``dgates .
    W_hh`` to it to get the step's ``dh_prev``."""
    keep = keep.to(torch.float32)[None, :, None]
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    tanh_c = torch.tanh(c_t)
    dh_eff = dh * keep
    dc_tot = dc * keep + dh_eff * o * (1.0 - tanh_c * tanh_c)
    dgates = torch.cat([
        dc_tot * g * i * (1.0 - i),
        dc_tot * c_prev * f * (1.0 - f),
        dc_tot * i * (1.0 - g * g),
        dh_eff * tanh_c * o * (1.0 - o),
    ], dim=-1)
    return dgates, (1.0 - keep) * dh, (1.0 - keep) * dc + dc_tot * f


def lstm_saved_state_backward(gates_all, c_all, h_all, weight_hh, lengths,
                              dh, dc, plain):
    """``_lstm_saved_state_bwd`` for D directions, from kernel A's saved
    ``gates_all [D, T, B, 4H]``, ``c_all``, ``h_all [D, T, B, H]``, the f32
    master ``weight_hh [D, 4H, H]``, int32 ``lengths [B]`` and the final
    state's cotangents ``dh``, ``dc [D, B, H]``, all f32 and contiguous:
    ``(dgates_all [D, T, B, 4H], dweight_hh [D, 4H, H])``, f32.
    ``plain`` runs kernel B's plain version; otherwise the tensors are
    checked once and each step only launches kernel B."""
    directions, seq_len, batch, four_h = gates_all.shape
    hidden = h_all.shape[-1]
    dgates_all = torch.empty_like(gates_all)
    if plain:
        zeros = torch.zeros_like(dh)
        steps = torch.arange(seq_len, device=lengths.device)
        keep_all = steps[:, None] < lengths[None, :]
    else:
        from dl_vqa_tpu_torch.ops.lstm_cuda import lstm_backward_step_launcher

        dh, dc = dh.clone(), dc.clone()  # kernel B updates both in place
        launch = lstm_backward_step_launcher(gates_all, c_all, lengths, dh,
                                             dc, dgates_all)
    for t in reversed(range(seq_len)):
        if plain:
            c_prev = c_all[:, t - 1] if t else zeros
            dgates_all[:, t], dh, dc = lstm_backward_step_reference(
                gates_all[:, t], c_all[:, t], c_prev, keep_all[t], dh, dc)
        else:
            launch(t)
        # dh_prev = (1 - keep) * dh + dgates . W_hh, a plain product, in
        # place: kernel B's next step finds dh where it was.
        dh.baddbmm_(dgates_all[:, t], weight_hh)
    # dW_hh = sum over t of dgates[t]^T h[t - 1]; step 0's carry is zero, so
    # its term drops out and the views need no copy (T = 1: zero rows).
    rows = max(seq_len - 1, 0) * batch
    dweight_hh = torch.matmul(
        dgates_all[:, 1:].reshape(directions, rows, four_h).transpose(1, 2),
        h_all[:, :-1].reshape(directions, rows, hidden))
    return dgates_all, dweight_hh


class LstmRecurrence(torch.autograd.Function):
    """``(x_proj [D, T, B, 4H] f32, weight_hh [D, 4H, H] f32, lengths [B],
    dtype, save, plain) -> (h, c)``, each ``[D, B, H]`` f32.

    Both operands are rounded to ``dtype`` here, so the backward still
    sees the f32 master ``weight_hh`` and returns ``x_proj``'s cotangent
    in f32. ``save`` says whether a backward will follow (an
    ``autograd.Function`` cannot see the grad mode it was called under).
    """

    @staticmethod
    def forward(ctx, x_proj, weight_hh, lengths, dtype, save, plain):
        plain = plain or x_proj.device.type == "cpu"
        xq = x_proj.to(dtype)
        wq = weight_hh.to(dtype).contiguous()
        lengths = lengths.to(torch.int32)
        if plain:
            run, run_save = (lstm_recurrence_reference,
                             lstm_recurrence_save_reference)
        else:
            from dl_vqa_tpu_torch.ops.lstm_cuda import (
                lstm_recurrence_cuda as run,
                lstm_recurrence_save_cuda as run_save)
        if not save:
            return run(xq, wq, lengths)
        h, c, *saved = run_save(xq, wq, lengths)
        ctx.save_for_backward(weight_hh, lengths, *saved)
        ctx.plain = plain
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        weight_hh, lengths, gates_all, c_all, h_all = ctx.saved_tensors
        dgates_all, dweight_hh = lstm_saved_state_backward(
            gates_all, c_all, h_all, weight_hh.float().contiguous(), lengths,
            dh.float().contiguous(), dc.float().contiguous(), ctx.plain)
        return dgates_all, dweight_hh, None, None, None, None


def lstm_recurrence_grad(x_proj: torch.Tensor, weight_hh: torch.Tensor,
                         lengths: torch.Tensor, dtype: torch.dtype,
                         plain: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable recurrence: f32 ``x_proj`` and master
    ``weight_hh`` in, final f32 ``(h, c)`` out, computed in ``dtype``."""
    save = torch.is_grad_enabled() and (x_proj.requires_grad
                                        or weight_hh.requires_grad)
    return LstmRecurrence.apply(x_proj, weight_hh, lengths, dtype, save,
                                plain)


def input_projections(xs: Sequence[torch.Tensor],
                      params: Sequence[Dict[str, torch.Tensor]]
                      ) -> torch.Tensor:
    """One ``x [B, T, E]`` and one weight set per direction -> time-major
    ``x @ W_ih^T + b`` ``[D, T, B, 4H]`` in f32. The product runs in f32,
    as ``jnp.dot`` of a bf16 input and the f32 weight does in the JAX
    package; the caller rounds the result to the compute dtype."""
    x_t = torch.stack([x.transpose(0, 1) for x in xs]).float()  # [D,T,B,E]
    w_t = torch.stack([p["weight_ih"].float().t() for p in params])
    bias = torch.stack([p["bias"].float() for p in params])
    directions, seq_len, batch, emb = x_t.shape
    proj = torch.bmm(x_t.reshape(directions, seq_len * batch, emb), w_t)
    proj = proj + bias[:, None, :]
    return proj.reshape(directions, seq_len, batch, -1)


def lstm_scan(x: torch.Tensor, lengths: torch.Tensor,
              params: Dict[str, torch.Tensor], plain: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked forward LSTM over ``x [B, T, E]``; final f32 ``(h, c)``,
    each ``[B, H]`` (the state at step ``len - 1``)."""
    h, c = lstm_recurrence_grad(
        input_projections([x], [params]),
        params["weight_hh"].float().unsqueeze(0), lengths, x.dtype, plain)
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
                      plain: bool = False) -> torch.Tensor:
    """Final cell states of both directions, ``[c_fwd, c_bwd]`` ->
    ``[B, 2H]`` f32. Both directions run in one recurrence (``D = 2``)."""
    x_proj = input_projections([x, reverse_valid_prefix(x, lengths)],
                               [fwd_params, bwd_params])
    w_hh = torch.stack([fwd_params["weight_hh"].float(),
                        bwd_params["weight_hh"].float()])
    _, c = lstm_recurrence_grad(x_proj, w_hh, lengths, x.dtype, plain)
    return torch.cat([c[0], c[1]], dim=-1)
