"""The transformer question encoder (``text.encoder == "transformer"``) and
the layer norm it shares with the ViT image encoder. Port of
``dl_vqa_tpu/models/transformer.py``.

A pre-LN transformer over the embedded question tokens with a padding
mask, pooled by a masked mean. The numerics are the JAX module's, which
no Pallas kernel reaches on any backend:

- the embedding row of id 0 is zeroed (``x * (questions > 0)``), the
  input projection is an f32 product of operands rounded to the compute
  dtype, and ``pos[:T]`` is added in f32 before the cast to the compute
  dtype; a question longer than the position table raises;
- the fused ``qkv`` projection stays in f32, so ``q . k^T`` is an f32
  product (TF32 stays off), the logits are masked with ``-1e30`` before
  the softmax, and the softmax weights and ``v`` are rounded to the
  compute dtype for the weighted sum;
- the MLP (``4 D`` wide, ReLU) and the residual adds as the ViT block's;
- the output is the final layer norm in f32, ``tokens [B, T, D]``, and
  their mean over the valid positions, divided by ``max(len, 1)``.

Dropout sites, in the order the port draws them from the one generator
(the JAX module keys them ``0``, ``2 i + 1`` and ``2 i + 2`` under the
text encoder's rng): after the position add, then per block on the
attention branch and on the MLP branch.

State-dict names (the port's own, as the JAX package's exporter refuses
this family): ``text.embedding.weight``, ``text.in_proj.{weight, bias}``,
``text.pos`` ``[max_positions, D]``, ``text.final_ln.{weight, bias}`` and
per block ``text.blocks.{i}.{ln1, ln2}.{weight, bias}`` and
``text.blocks.{i}.{qkv, out, mlp_in, mlp_out}.{weight, bias}``; linear
weights are ``[out, in]``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from dl_vqa_tpu_torch.models.layers import dropout as _dropout, mm as _mm
from dl_vqa_tpu_torch.parallel.tensor import reduce_from, vocab_lookup

__all__ = ["layer_norm", "LayerNorm", "TransformerText", "TextBlock"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis as ``_layer_norm`` of the JAX package
    computes it: mean and biased variance in f32, ``rsqrt(var + eps)``,
    scale and bias in f32, and the result cast back to ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centred = x32 - mean
    var = (centred * centred).mean(dim=-1, keepdim=True)
    return (centred * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


class LayerNorm(nn.Module):
    """Scale (``weight``) and ``bias`` of a layer norm; scale 1, bias 0."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


def _self_attention(x: torch.Tensor, qkv: nn.Linear, out: nn.Linear,
                    mask: torch.Tensor, num_heads: int, dtype: torch.dtype,
                    tp=None) -> torch.Tensor:
    """``_self_attention`` of the JAX module: ``x [B, T, D]`` in the compute
    dtype, ``mask [B, T]`` (valid keys) -> the f32 output projection.
    ``tp``: ``qkv`` holds this rank's ``num_heads`` heads (packed ``[q | k
    | v]``) and ``out`` their rows; the f32 partial outputs are summed
    before the bias."""
    batch, seq, _ = x.shape
    head = qkv.weight.shape[0] // (3 * num_heads)
    packed = _mm(x, qkv.weight, tp) + qkv.bias  # f32, as the JAX module keeps it
    q, k, v = (t.reshape(batch, seq, num_heads, head).transpose(1, 2)
               for t in packed.chunk(3, dim=-1))
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head)
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    weights = torch.softmax(logits, dim=-1).to(dtype)
    # Products of values rounded to the compute dtype, summed in f32.
    att = torch.matmul(weights.float(), v.to(dtype).float())
    att = att.transpose(1, 2).reshape(batch, seq, -1).to(dtype)
    return reduce_from(_mm(att, out.weight), tp) + out.bias


class TextBlock(nn.Module):
    """One pre-LN block: ``x + drop(out(attention(qkv(ln1(x)))))``, then
    ``x + drop(mlp_out(relu(mlp_in(ln2(x)))))``. Under 'model' (``tp``)
    ``qkv`` and ``mlp_in`` are column-parallel (``qkv`` by heads, and
    ``num_heads`` is this rank's count), ``out`` and ``mlp_out``
    row-parallel; where the axis does not divide the heads, ``qkv`` and
    ``out`` stay whole (``tp`` None) and only the MLP splits
    (``mlp_tp``)."""

    tp = None
    mlp_tp = None

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.ln1 = LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)
        self.ln2 = LayerNorm(dim)
        self.mlp_in = nn.Linear(dim, 4 * dim)
        self.mlp_out = nn.Linear(4 * dim, dim)

    def set_shards(self, shards) -> None:
        if self.qkv.weight.shape[0] < 3 * self.dim:
            self.tp = shards["model"]
            self.num_heads //= self.tp.size
        if self.mlp_in.weight.shape[0] < 4 * self.dim:
            self.mlp_tp = shards["model"]

    def forward(self, x, mask, dtype, rate, generator):
        att = _self_attention(self.ln1(x), self.qkv, self.out, mask,
                              self.num_heads, dtype, self.tp).to(dtype)
        x = x + _dropout(att, rate, generator)
        tp = self.mlp_tp
        hidden = torch.relu(_mm(self.ln2(x), self.mlp_in.weight, tp)
                            + self.mlp_in.bias).to(dtype)
        mlp = (reduce_from(_mm(hidden, self.mlp_out.weight), tp)
               + self.mlp_out.bias).to(dtype)
        return x + _dropout(mlp, rate, generator)


class TransformerText(nn.Module):
    """``init_transformer_text`` and ``apply_transformer_text`` of the JAX
    package as a module: embedding (``cfg.num_tokens`` x E), input
    projection to ``D = text.question_features``, ``pos [max_positions,
    D]``, ``text.num_layers`` blocks of ``text.num_heads`` heads, final
    layer norm."""

    vocab = None  # the 'model' Shard of the embedding's rows, if split

    def __init__(self, cfg):
        super().__init__()
        t = cfg.text
        dim = t.question_features
        self.dropout = t.dropout
        self.num_tokens = cfg.num_tokens
        self.embedding = nn.Embedding(cfg.num_tokens, t.embedding_features)
        self.in_proj = nn.Linear(t.embedding_features, dim)
        self.pos = nn.Parameter(torch.empty(t.max_positions, dim))
        self.blocks = nn.ModuleList(
            TextBlock(dim, t.num_heads) for _ in range(t.num_layers))
        self.final_ln = LayerNorm(dim)

    def forward(self, questions: torch.Tensor, lengths: torch.Tensor,
                dtype: torch.dtype, plain: bool,
                generator: Optional[torch.Generator],
                need_tokens: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           torch.Tensor]:
        """``questions [B, T]``, ``lengths [B]`` -> ``(pooled [B, D],
        tokens [B, T, D] or None, mask [B, T])``, pooled and tokens f32;
        the tokens only where ``need_tokens``, as ``encode_text`` returns
        them. ``plain`` is the LSTM text encoder's: no hand kernel runs
        here."""
        seq = questions.shape[1]
        if seq > self.pos.shape[0]:
            raise ValueError(
                f"Question length {seq} exceeds the positional table size "
                f"{self.pos.shape[0]}; raise train.text.max_positions to "
                f"at least the dataset's max_question_length and retrain.")
        mask = (torch.arange(seq, device=questions.device)[None, :]
                < lengths.to(questions.device)[:, None])
        x = vocab_lookup(self.embedding.weight, questions, self.vocab)
        x = x * (questions > 0).unsqueeze(-1)
        x = _mm(x.to(dtype), self.in_proj.weight) + self.in_proj.bias
        x = (x + self.pos[:seq]).to(dtype)
        x = _dropout(x, self.dropout, generator)
        for block in self.blocks:
            x = block(x, mask, dtype, self.dropout, generator)
        tokens = self.final_ln(x).float()
        denom = mask.sum(dim=1, keepdim=True).clamp(min=1).float()
        pooled = (tokens * mask[..., None]).sum(dim=1) / denom
        return pooled, (tokens if need_tokens else None), mask

    def set_shards(self, shards) -> None:
        if self.embedding.weight.shape[0] < self.num_tokens:
            self.vocab = shards["model"]
