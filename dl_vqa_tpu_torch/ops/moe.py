"""Mixture-of-experts MLP of the ViT blocks (``image.moe_experts > 0``).

Port of ``dl_vqa_tpu/ops/moe.py``: the GShard/Switch top-k gating with a
fixed per-expert capacity, and the expert FFN it routes to. The routing is
the JAX function's, step for step (:func:`top_k_gating`): an f32 router
softmax; per slot the ``argmax`` over the experts not yet chosen (the
first on ties; where every other probability has underflowed to 0 it may
choose an expert already taken, as the JAX code does); each token's place
in its expert by a cumulative sum over the group's tokens plus what earlier
slots kept; a drop past capacity; the Switch balance loss ``E * sum_e f_e *
P_e`` from the first choice before capacity; the raw gate for ``top_k ==
1`` and ``g / (sum of kept g + 1e-9)`` for ``top_k >= 2`` (the ``+ 1e-9``
keeps the backward of a token that all its experts dropped finite).

What differs is how tokens reach the experts. The JAX package builds one-hot
``dispatch`` and ``combine`` tensors ``[G, S, E, C]`` and moves tokens with
einsums, which XLA tiles onto the TPU's matrix unit. At the
``config_vit_moe`` shapes (G = 512 images, S = 196, E = 8, C = 62) one such
f32 tensor is 199 MB and each einsum 25.5 GFLOP a layer. Here the routing
is kept as indices (:class:`Routing`: the expert, slot and weight of each
``(g, s, k)``) and :func:`moe_mlp` moves the tokens by index into an ``[E,
G, C, D]`` buffer in the compute dtype (130 MB at those shapes) and back.
That gives the einsums' bits: a dispatched element is one term plus zeros,
so it is the token's value; a combined element of ``top_k <= 2`` in bf16
is two exact f32 products of bf16 operands summed and rounded once, which
is what the einsum's f32 accumulation gives (in f32 a product is itself
rounded, and an einsum's fused multiply-add may skip one such rounding:
top-2 there lies within one f32 step of it). Slots that hold no token are
computed (``relu(b_in)`` drives them) and gathered by no token, so they get
no gradient, as the one-hot combine gives them none.

Expert parallelism ('expert', :meth:`MoeMlp.set_shards`) splits the
experts over the ranks of an 'expert' group, ``E / expert`` each, and
'model' splits each expert's hidden width F. The tokens are replicated over
'expert', as JAX places them: each rank routes every token of its 'data'
shard with the replicated f32 router and dispatches only the slots of its
own experts. The expert output ``y`` is summed over 'model' in f32 before
``out.b`` and the rounding to the compute dtype, and the combined ``[G, S,
D]`` over 'expert' in f32, then rounded once. A token's combined value is
at most ``top_k`` nonzero slot terms, and the sum over 'expert' adds the
other ranks' zeros: with ``top_k <= 2`` and 'model' 1 the ranks give one
process's bits. The routing weights and the dispatched tokens take the
gradient of this rank's slots only: their gradients are summed over the
ranks (over 'expert', and over 'expert' x 'model'), so the replicated
router and everything before the block get one process's gradient on
every rank.

Under 'seq' (:mod:`dl_vqa_tpu_torch.parallel.sequence`) a rank holds ``S /
n`` contiguous tokens of every group, and a group is still the image: its
capacity counts the whole sequence's tokens, and a token's place in its
expert adds, for each slot, the choices of that slot on the earlier 'seq'
ranks (an exclusive prefix of the ranks' ``[G, E]`` counts, all-gathered
over 'seq') to what earlier slots kept over the whole sequence. Each rank
then runs the experts on its own kept tokens, so the ranks keep one
process's routes. The balance loss's factors stay the rank's means; the
train step takes them over every rank of the batch and the sequence.
An all-to-all that splits the groups over 'expert' in place
of the replicated tokens is ROADMAP queue 1's later work.

The router product is an f32 product of f32 operands (TF32 is off in the
port, as ``models/layers.py::mm`` assumes); the two expert products are f32
results of operands rounded to the compute dtype, ``torch.bmm`` over the
experts, with the bias, ReLU and casts where the JAX code has them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

import torch.distributed as dist

from dl_vqa_tpu_torch.parallel.tensor import copy_to, reduce_from

__all__ = ["moe_capacity", "Routing", "top_k_gating", "moe_mlp", "MoeMlp",
           "balance_loss", "MOE_WITHOUT_ROUTING"]

# The JAX model's words where MoE parameters meet a configuration without
# the routing knobs (dl_vqa_tpu/models/vit.py::apply_vit_block).
MOE_WITHOUT_ROUTING = (
    "layer params contain a 'moe' group but no MoE routing config was "
    "provided — the checkpoint was trained with image.moe_experts > 0; "
    "evaluate/serve it with a config that sets image.moe_experts (and the "
    "trained moe_top_k / moe_capacity_factor)")


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity: ``ceil(top_k * S * factor / E)``, at
    least 1."""
    return max(1, int(math.ceil(top_k * num_tokens * capacity_factor
                                / num_experts)))


class Routing(NamedTuple):
    """Where each slot ``(g, s, k)`` of a token goes. ``expert`` and
    ``position`` ``[G, S, K]`` int64 (the position is ``>= capacity`` where
    the slot was dropped), ``kept`` ``[G, S, K]`` bool, ``weight`` ``[G, S,
    K]`` f32 (the combine weight, 0 where dropped), the scalar ``aux``
    balance loss and its factors ``frac`` (each expert's share of first
    choices, no gradient) and ``mean_prob`` (its mean router probability),
    ``[E]`` f32: ``aux = E * sum(frac * mean_prob)``."""

    expert: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor
    frac: torch.Tensor
    mean_prob: torch.Tensor

    def dense(self, num_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX function's ``(dispatch, combine)``, both f32 ``[G, S, E,
        C]``: the slot's one-hot at ``(expert, position)`` where it was
        kept, times its weight for ``combine``."""
        expert = nn.functional.one_hot(self.expert, num_experts).float()
        place = nn.functional.one_hot(
            self.position.clamp(max=capacity), capacity + 1)[..., :capacity]
        slot = (expert * self.kept[..., None].float())[..., None] \
            * place.float()[..., None, :]                    # [G, S, K, E, C]
        return (slot.sum(2),
                (slot * self.weight[..., None, None]).sum(2))


def balance_loss(frac: torch.Tensor, mean_prob: torch.Tensor
                 ) -> torch.Tensor:
    """The Switch balance loss ``E * sum_e frac_e * mean_prob_e`` over the
    last axis (the experts) of the factors a :func:`moe_mlp` gives its
    ``aux_sink``."""
    return frac.shape[-1] * torch.sum(frac * mean_prob, dim=-1)


def _seq_counts(local: torch.Tensor, seq) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``(before, total)``: the sums of the 'seq' ranks' ``[G, E]`` counts
    over the ranks before this one and over all of them (integers in f32:
    exact)."""
    parts = [torch.empty_like(local) for _ in range(seq.size)]
    dist.all_gather(parts, local.contiguous(), group=seq.group)
    before = torch.zeros_like(local)
    for part in parts[:seq.index]:
        before = before + part
    return before, torch.stack(parts).sum(0)


def top_k_gating(logits: torch.Tensor, top_k: int, capacity: int,
                 seq=None) -> Routing:
    """GShard top-k gating with capacity on router logits ``[G, S, E]``
    (any float dtype, promoted to f32), as
    ``dl_vqa_tpu/ops/moe.py::top_k_gating`` computes it. ``seq``: the
    :class:`~dl_vqa_tpu_torch.parallel.sequence.SequenceContext` whose
    rank holds these ``S`` tokens of longer groups (module docstring);
    ``frac`` and ``mean_prob`` are then this rank's means."""
    if top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    num_experts = logits.shape[-1]
    if top_k > num_experts:
        raise ValueError(f"top_k={top_k} exceeds num_experts={num_experts}")
    probs = torch.softmax(logits.float(), dim=-1)            # [G, S, E]
    counts = probs.new_zeros(probs.shape[0], num_experts)    # [G, E]
    remaining = probs
    experts, positions, kept, gates = [], [], [], []
    aux = frac = mean_prob = None
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                # [G, S]
        onehot = nn.functional.one_hot(idx, num_experts).float()
        if aux is None:
            # Switch balance loss from the FIRST choice, before capacity.
            frac = onehot.mean(dim=(0, 1))
            mean_prob = probs.mean(dim=(0, 1))
            aux = num_experts * torch.sum(frac * mean_prob)
        # A token's place in its expert: the group's earlier tokens in this
        # slot, plus everything kept in earlier slots.
        pos_in_e = (torch.cumsum(onehot, dim=1) - onehot
                    + counts[:, None, :])
        if seq is not None:
            # The slot's choices on the earlier 'seq' ranks come first.
            before, total = _seq_counts(onehot.sum(dim=1), seq)
            pos_in_e = pos_in_e + before[:, None, :]
        keep = onehot * (pos_in_e < capacity)
        if seq is None:
            counts = counts + keep.sum(dim=1)
        else:
            # The whole sequence's places in [counts, counts + total) of
            # each expert: what fits below the capacity was kept.
            counts = counts + torch.minimum(
                total, (capacity - counts).clamp(min=0.0))
        experts.append(idx)
        positions.append((pos_in_e * onehot).sum(dim=-1).long())
        kept.append(keep.sum(dim=-1) > 0)
        # The router probability of a kept slot (0 if dropped), whose
        # gradient reaches the router.
        gates.append(torch.gather(probs, -1, idx[..., None])[..., 0]
                     * kept[-1])
        remaining = remaining * (1.0 - onehot)
    gate = torch.stack(gates, dim=-1)                        # [G, S, K]
    if top_k == 1:
        # Switch: the raw router probability scales the expert output.
        weight = gate
    else:
        weight = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    return Routing(torch.stack(experts, -1), torch.stack(positions, -1),
                   torch.stack(kept, -1), weight, aux, frac, mean_prob)


def moe_mlp(x: torch.Tensor, gate: torch.Tensor, w_in: torch.Tensor,
            b_in: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
            top_k: int, capacity_factor: float,
            aux_sink: Optional[list] = None, ep=None, tp=None,
            ep_tp=None, seq=None) -> torch.Tensor:
    """Sparsely activated expert FFN ``x [G, S, D] -> [G, S, D]`` in x's
    dtype (the compute dtype), with the router ``gate [E, D]`` and the
    experts ``w_in [E, F, D]``, ``b_in [E, F]``, ``w_out [E, D, F]``,
    ``b_out [E, D]`` (``[out, in]``, as the port's linears). Each group's
    tokens are routed on their own (capacity is per group); a dropped slot
    adds nothing and the token rides the block's residual. ``aux_sink``, a
    list, receives the factors of the layer's balance loss, ``(frac,
    mean_prob)`` (:func:`balance_loss`), for the caller to take the
    fractions over whatever batch it means (every rank's tokens, in a
    data-parallel step).

    ``ep``, ``tp``, ``ep_tp``: the 'expert', 'model' and 'expert' x
    'model' Shards of a split block (module docstring), whose ``w_in``,
    ``b_in``, ``w_out``, ``b_out`` hold this rank's experts and hidden
    columns; ``seq``: the 'seq' context of a rank holding ``S`` tokens of
    each group; None in one process."""
    dtype = x.dtype
    groups, tokens, dim = x.shape
    num_experts = gate.shape[0]
    local_experts = w_in.shape[0]
    first = 0 if ep is None else ep.index * local_experts
    capacity = moe_capacity(tokens * (1 if seq is None else seq.size),
                            num_experts, top_k, capacity_factor)
    logits = torch.matmul(x.float(), gate.t())               # [G, S, E] f32
    routing = top_k_gating(logits, top_k, capacity, seq)
    if aux_sink is not None:
        aux_sink.append((routing.frac, routing.mean_prob))

    # A slot's row of the [E, G, C] buffer; a dropped slot writes a spare
    # last row, which is cut off, and gathers row 0 with weight 0.
    # This rank's slots: kept, and routed to one of its experts.
    mine = routing.kept
    if ep is not None:
        mine = mine & (routing.expert >= first) & (
            routing.expert < first + local_experts)
    group = torch.arange(groups, device=x.device)[:, None, None]
    rows = ((routing.expert - first) * groups + group) * capacity \
        + routing.position
    slots = local_experts * groups * capacity
    rows = torch.where(mine, rows, slots).reshape(-1)
    src = copy_to(x, ep_tp).unsqueeze(2).expand(
        groups, tokens, top_k, dim).reshape(-1, dim)
    xin = x.new_zeros(slots + 1, dim).index_copy(0, rows, src)[:slots]
    xin = xin.view(local_experts, groups * capacity, dim)

    hidden = torch.relu(
        torch.bmm(xin.float(), w_in.to(dtype).float().transpose(1, 2))
        + b_in[:, None, :]).to(dtype)
    y = torch.bmm(hidden.float(), w_out.to(dtype).float().transpose(1, 2))
    y = (reduce_from(y, tp) + b_out[:, None, :]).to(dtype)

    picked = y.reshape(slots, dim).index_select(
        0, torch.where(rows < slots, rows, 0))
    picked = picked.view(groups, tokens, top_k, dim)
    weight = routing.weight
    if ep is not None:
        weight = torch.where(mine, copy_to(weight, ep), 0.0)
    weight = weight.to(dtype).float()[..., None]
    return reduce_from((weight * picked.float()).sum(dim=2), ep).to(dtype)


class _Experts(nn.Module):
    """One expert-major linear: ``weight [E, out, in]``, ``bias [E, out]``."""

    def __init__(self, experts: int, out_features: int, in_features: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(experts, out_features, in_features))
        self.bias = nn.Parameter(torch.empty(experts, out_features))


class MoeMlp(nn.Module):
    """The MoE FFN's parameters: ``gate [E, D]``, ``in.{weight [E, F, D],
    bias [E, F]}``, ``out.{weight [E, D, F], bias [E, D]}``; of a split
    block (:meth:`set_shards`) this rank's experts and hidden columns."""

    ep = tp = ep_tp = seq = None

    def __init__(self, dim: int, hidden: int, experts: int):
        super().__init__()
        self.hidden = hidden
        self.gate = nn.Parameter(torch.empty(experts, dim))
        self.add_module("in", _Experts(experts, hidden, dim))
        self.add_module("out", _Experts(experts, dim, hidden))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """U(+-1/sqrt(fan_in)) for every tensor, fan_in the layer's input
        width, as ``init_moe_mlp`` draws them."""
        dim, hidden = self.gate.shape[1], getattr(self, "in").weight.shape[1]
        for p, fan_in in ((self.gate, dim),
                          (getattr(self, "in").weight, dim),
                          (getattr(self, "in").bias, dim),
                          (getattr(self, "out").weight, hidden),
                          (getattr(self, "out").bias, hidden)):
            bound = 1.0 / math.sqrt(fan_in)
            p.uniform_(-bound, bound, generator=gen)

    def set_shards(self, shards) -> None:
        self.seq = shards.get("seq")
        e_in = getattr(self, "in")
        if e_in.weight.shape[0] < self.gate.shape[0]:
            self.ep = shards["expert"]
        if e_in.weight.shape[1] < self.hidden:
            self.tp = shards["model"]
        if self.ep is not None or self.tp is not None:
            self.ep_tp = shards["expert_model"]

    def forward(self, x: torch.Tensor, top_k: int, capacity_factor: float,
                aux_sink: Optional[list] = None) -> torch.Tensor:
        e_in, e_out = getattr(self, "in"), getattr(self, "out")
        return moe_mlp(x, self.gate, e_in.weight, e_in.bias, e_out.weight,
                       e_out.bias, top_k, capacity_factor, aux_sink,
                       self.ep, self.tp, self.ep_tp, self.seq)
