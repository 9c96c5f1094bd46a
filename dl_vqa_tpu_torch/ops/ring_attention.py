"""Ring attention: self-attention over the tokens a 'seq' group holds.

Port of ``dl_vqa_tpu/ops/ring_attention.py``. The JAX ring is einsums in
a ``shard_map`` with ``lax.ppermute`` between its steps, not a Pallas
kernel, and here it is plain PyTorch: matrix products and an autograd
Function that rotates the k and v blocks around the ring
(``dist.batch_isend_irecv`` on the 'seq' group: send to the next rank,
receive from the previous; its backward is the reverse ring, the
transpose of ``ppermute``). Autograd differentiates the fold through the
rotations, as JAX differentiates its scan.

Step for step as the JAX function: each rank folds its own k/v block
first, then the blocks of ranks r - 1, r - 2, ...; ``n - 1`` rotations,
the last fold outside the loop; the online softmax's ``m``, ``l`` and
``o`` in f32; the logits an f32 product of the operands as they are
(``preferred_element_type=float32``) times the scale; ``p`` cast to v's
dtype before its product; the output ``o / l`` cast to q's dtype.

Over gloo a CUDA tensor is staged through host memory for the exchange:
gloo's send and receive take host buffers.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

__all__ = ["ring_attention_block", "ring_attention_qkv"]


def _exchange(tensors: Sequence[torch.Tensor], to: int, frm: int,
              group) -> List[torch.Tensor]:
    """Send ``tensors`` to global rank ``to`` and receive their likes from
    ``frm``, in one batch."""
    host = (dist.get_backend(group) == "gloo"
            and any(t.is_cuda for t in tensors))
    staged = [(t.cpu() if host else t).contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in staged]
    ops = ([dist.P2POp(dist.isend, t, to, group) for t in staged]
           + [dist.P2POp(dist.irecv, r, frm, group) for r in received])
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return [r.to(t.device) for r, t in zip(received, tensors)]


class _Rotate(torch.autograd.Function):
    """``(k, v, seq) -> (k, v)`` of the previous rank of the ring; the
    gradients go back the other way."""

    @staticmethod
    def forward(ctx, k, v, seq):
        ctx.seq = seq
        return tuple(_exchange((k, v), seq.next_rank, seq.prev_rank,
                               seq.group))

    @staticmethod
    def backward(ctx, grad_k, grad_v):
        seq = ctx.seq
        grad_k, grad_v = _exchange((grad_k, grad_v), seq.prev_rank,
                                   seq.next_rank, seq.group)
        return grad_k, grad_v, None


def ring_attention_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         seq, scale: float) -> torch.Tensor:
    """``softmax(q k_full^T * scale) v_full`` for this rank's queries.

    ``q, k, v``: ``[B, H, S_local, Dh]``, this rank's query tokens and its
    k/v block; ``seq``: the
    :class:`~dl_vqa_tpu_torch.parallel.sequence.SequenceContext` of the
    ring. Returns ``[B, H, S_local, Dh]`` in q's dtype."""
    shape = q.shape[:-1]
    qf = q.float()

    def fold(m, l, o, k_blk, v_blk):
        logits = torch.matmul(qf, k_blk.float().transpose(-1, -2)) * scale
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)  # rescale prior contributions
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.matmul(
            p.to(v_blk.dtype).float(), v_blk.float())
        return m_new, l, o

    m = torch.full(shape, -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros(shape, dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for _ in range(seq.size - 1):
        m, l, o = fold(m, l, o, k_blk, v_blk)
        k_blk, v_blk = _Rotate.apply(k_blk, v_blk, seq)
    _, l, o = fold(m, l, o, k_blk, v_blk)
    return (o / l[..., None]).to(q.dtype)


def ring_attention_qkv(qkv: torch.Tensor, num_heads: int, seq
                       ) -> torch.Tensor:
    """Sequence-parallel attention on this rank's tokens of a packed qkv
    projection ``[B, S_local, 3 * H * Dh]`` (q | k | v, each head-major):
    the merged ``[B, S_local, H * Dh]`` in qkv's dtype."""
    batch, local, three_dim = qkv.shape
    dim = three_dim // 3
    head = dim // num_heads

    def heads(t):
        return t.reshape(batch, local, num_heads, head).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
    out = ring_attention_block(q, k, v, seq, 1.0 / head ** 0.5)
    return out.transpose(1, 2).reshape(batch, local, dim)
