"""Sequence parallelism: the 'seq' mesh axis (``tpu.mesh.seq``).

The port's counterpart of ``dl_vqa_tpu/parallel/sequence.py``. The ViT's
patch tokens split over the ranks of a 'seq' group, ``S / n`` contiguous
tokens each, as JAX places them with ``P('data', 'seq', None)``:

* after the patch embedding, the position table and dropout site 20
  (drawn for the whole sequence), each rank keeps its tokens
  (:meth:`SequenceContext.scatter`);
* the blocks' token-local work (layer norms, products, MLP) runs on them,
  and each block's attention rides the ring
  (:func:`dl_vqa_tpu_torch.ops.ring_attention.ring_attention_qkv`) in place
  of kernels 4 and 5, as the JAX model takes the ring in place of its
  Pallas kernel; the blocks' dropout sites draw the whole sequence's mask
  and keep the rank's tokens (:class:`~dl_vqa_tpu_torch.models.layers.
  BatchRows`);
* after the final layer norm the ranks gather the sequence
  (:meth:`SequenceContext.gather`, whose backward keeps this rank's slice
  of the gradient: every rank of the group computes that gradient whole,
  so a reduce-scatter would count it ``n`` times). All that follows is the
  same on every rank of the group.

The ViT's parameter gradients are then each rank's partial sums, which
the train step sums over the group in f32; the gradients of what follows
the gather are the same on every rank and are given the coordinate-0
rank's bits (:func:`sync_sequence_grads`). The ranks of one 'seq' group
hold the same rows of the batch ('data' splits the batch, 'seq' the
tokens). Under 'model' each rank's packed ``qkv`` holds its heads, and
those ride the ring. A ViT-MoE routes each image's tokens across the
ranks as one process routes them (:mod:`dl_vqa_tpu_torch.ops.moe`), and
the int8 ViT's four W8A8 products are token-local with static scales, so
each rank runs its tokens.

What the JAX package refuses, the port refuses with its words: the CNN,
which has no token dimension, 'seq' with 'stage', and a token count the
axis does not divide.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["SequenceContext", "check_sequence_parallel",
           "sync_sequence_grads", "NO_TOKEN_DIMENSION"]

NO_TOKEN_DIMENSION = (
    "tpu.mesh.seq > 1 (sequence parallelism) requires "
    "train.image.encoder=vit — the cnn stack has no token "
    "dimension to shard")


@dataclasses.dataclass(frozen=True)
class SequenceContext:
    """This rank's place on the 'seq' axis: the axis's process group, its
    size, this rank's coordinate and the group's global ranks in
    coordinate order (the ring's neighbours)."""

    group: object
    size: int
    index: int
    ranks: Tuple[int, ...]

    @classmethod
    def of(cls, mesh) -> Optional["SequenceContext"]:
        """The context of ``mesh``'s 'seq' axis; None where it has one
        rank or no group was joined."""
        if mesh is None or not mesh.distributed or mesh.size("seq") < 2:
            return None
        group = mesh.group("seq")
        ranks = tuple(dist.get_global_rank(group, i)
                      for i in range(mesh.size("seq")))
        return cls(group, mesh.size("seq"), mesh.coord("seq"), ranks)

    @property
    def next_rank(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    @property
    def prev_rank(self) -> int:
        return self.ranks[(self.index - 1) % self.size]

    def tokens(self, total: int) -> slice:
        """This rank's contiguous tokens of a sequence of ``total``; raises
        the JAX model's error where the axis does not divide it."""
        if total % self.size:
            raise ValueError(
                f"{total} patch tokens do not shard over the {self.size}-way "
                f"'seq' axis; choose image_size/patch_size so the grid "
                f"divides it")
        per = total // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's tokens (dim 1) of ``x [B, S, ...]``; the gradient of
        the others is zero here (the other ranks hold theirs)."""
        return x[:, self.tokens(x.shape[1])]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence from every rank's tokens (dim 1), in order;
        the backward keeps this rank's slice of the gradient."""
        return _Gather.apply(x, self)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq, ctx.width = seq, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(seq.size)]
        dist.all_gather(parts, x.contiguous(), group=seq.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.seq.index * ctx.width
        return grad.narrow(1, start, ctx.width), None


def check_sequence_parallel(seq: int, encoder: str) -> None:
    """Raise the JAX model's ``ValueError`` where an image encoder cannot
    take a 'seq' axis of ``seq`` ranks: the CNN."""
    if seq > 1 and encoder != "vit":
        raise ValueError(NO_TOKEN_DIMENSION)


def sync_sequence_grads(model, mesh) -> None:
    """Over the 'seq' group: sum the ViT's parameter gradients (each rank
    holds the part of its tokens) in f32, and give every rank the
    coordinate-0 rank's gradients of the rest, which every rank computes
    alike from the gathered sequence. Nothing where 'seq' has one rank."""
    seq = SequenceContext.of(mesh)
    if seq is None:
        return
    from torch.distributed.tensor import DTensor

    summed, synced = [], []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        grad = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
        (summed if name.startswith("image.") else synced).append(grad)
    for grads, reduce in ((summed, True), (synced, False)):
        if not grads:
            continue
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        if reduce:
            dist.all_reduce(flat, group=seq.group)
        else:
            dist.broadcast(flat, src=seq.ranks[0], group=seq.group)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
