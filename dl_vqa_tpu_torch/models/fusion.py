"""The attention variants beside the single one: stacked attention
(``attention.variant == "stacked"``) and co-attention (``"co"``). Port of
``dl_vqa_tpu/models/fusion.py``.

Both keep the classifier's input contract: the pooled image features
``[B, G * C]`` beside a question vector of ``text.output_features``.
The numerics are the JAX module's: the projections of ``v`` stored in the
compute dtype, the other products f32 results of operands rounded to the
compute dtype, the softmax pooling of ``v`` in f32 through kernel 3
(:func:`dl_vqa_tpu_torch.ops.attention_pool.attention_pool`, the custom op
``vqa::attention_pool``).

Dropout sites, in the order the port draws them (the JAX model keys them
``10 + site`` under its rng, ``dl_vqa_tpu/models/vqa.py::apply``):
stacked, ``v`` (site 0) then ``q`` (site 1); co, ``v`` (0), ``q`` (1)
and the fused tensor (2). Neither drops the ``v`` that is pooled, nor,
in co-attention, the ``v`` its guide is the mean of or the tokens.

Under 'model' (``tp``, ``set_shards``) both split as the single
attention does: ``v_conv`` and ``q_lin`` column-parallel, so the fused
tensor and the stacked query ``u`` hold this rank's columns; the
replicated scoring convs (``layers.{g}.score``, ``x_conv``) take this
rank's rows of their weight and the ranks sum the f32 partial scores
before the bias; the stacked ``update`` gives this rank's columns of its
output (its rows of the replicated weight and bias). Every other part
runs whole on every rank.

State-dict names (the port's own): ``attention.{v_conv, q_lin}`` in both;
stacked ``attention.layers.{g}.score`` (a 1x1 conv to one logit) and, for
every glimpse but the last, ``attention.layers.{g}.update`` (a linear from
the C attended features to the hidden width); co ``attention.{x_conv,
vsum_lin, tok_lin, tok_out}``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dl_vqa_tpu_torch.models.layers import dropout, mm as _mm
from dl_vqa_tpu_torch.ops.attention_pool import attention_pool
from dl_vqa_tpu_torch.parallel.tensor import (
    columns, copy_to, reduce_from, take_columns)

__all__ = ["StackedAttention", "CoAttention", "fuse", "project_v",
           "conv_scores"]


def fuse(v_proj: torch.Tensor, q_proj: torch.Tensor, do_option: str
         ) -> torch.Tensor:
    """``relu`` of ``v_proj [B, H, W, mid]`` fused with ``q_proj [B, mid]``
    tiled over the grid: product (``*``), sum (``+``) or channel concat
    (``|``, ``2 mid`` channels)."""
    q_tiled = q_proj[:, None, None, :]
    if do_option == "*":
        return torch.relu(v_proj * q_tiled)
    if do_option == "+":
        return torch.relu(v_proj + q_tiled)
    return torch.relu(torch.cat([v_proj, q_tiled.expand_as(v_proj)], dim=-1))


def project_v(v: torch.Tensor, v_conv: nn.Conv2d, dtype: torch.dtype
              ) -> torch.Tensor:
    """The 1x1 conv without bias over ``v [B, H, W, C]``, stored in the
    compute dtype as the JAX model stores it, taken straight from the
    product (a trip through f32 would change no bit and move the ``[B, H,
    W, hidden]`` tensor twice more)."""
    return torch.matmul(v.to(dtype), v_conv.weight[:, :, 0, 0].to(dtype).t())


class _Glimpse(nn.Module):
    def __init__(self, x_in: int, v_features: int, mid: int, last: bool):
        super().__init__()
        self.score = nn.Conv2d(x_in, 1, 1)
        self.update = None if last else nn.Linear(v_features, mid)


def conv_scores(fused, conv, cols=None, tp=None):
    """A 1x1 conv to the glimpse logits, f32. Under 'model' (``tp``) the
    weight is replicated and the fused tensor holds this rank's ``cols``:
    each rank takes those rows of the weight, the ranks sum their f32
    partial products, then the bias is added once."""
    weight = take_columns(copy_to(conv.weight[:, :, 0, 0], tp), cols)
    return reduce_from(_mm(fused, weight), tp) + conv.bias


class StackedAttention(nn.Module):
    """SAN-style stacked attention: each glimpse scores the grid against
    the query ``u``, pools ``v`` by the softmax of its scores (kernel 3 at
    one glimpse) and, but for the last, adds ``update(attended)`` to ``u``
    (kept in the compute dtype). Returns the glimpses' pooled features
    ``[B, G * C]`` f32."""

    tp = None

    def __init__(self, cfg):
        super().__init__()
        a = cfg.attention
        channels = cfg.image.output_channels
        self.do_option = a.do_option
        self.dropout = a.dropout
        self.hidden = a.hidden_dim
        x_in = 2 * a.hidden_dim if a.do_option == "|" else a.hidden_dim
        self.v_conv = nn.Conv2d(channels, a.hidden_dim, 1, bias=False)
        self.q_lin = nn.Linear(cfg.text.output_features, a.hidden_dim)
        self.layers = nn.ModuleList(
            _Glimpse(x_in, channels, a.hidden_dim, g + 1 == a.glimpses)
            for g in range(a.glimpses))

    def set_shards(self, shards) -> None:
        if self.v_conv.weight.shape[0] < self.hidden:
            self.tp = shards["model"]

    def forward(self, v: torch.Tensor, q: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator], plain: bool = False
                ) -> torch.Tensor:
        tp = self.tp
        v_proj = project_v(copy_to(dropout(v, self.dropout, generator),
                                   tp),  # site 0
                           self.v_conv, dtype)
        q_in = dropout(q, self.dropout, generator).to(dtype)  # site 1
        u = (_mm(q_in, self.q_lin.weight, tp) + self.q_lin.bias).to(dtype)
        cols = columns(tp, self.hidden, 2 if self.do_option == "|" else 1)
        pooled = []
        for layer in self.layers:
            fused = fuse(v_proj, u, self.do_option)
            scores = conv_scores(fused, layer.score, cols, tp)  # [B, H, W, 1]
            attended = attention_pool(v, scores, plain)  # [B, C] f32
            pooled.append(attended)
            if layer.update is not None:
                # f32 sum, stored in the compute dtype as the JAX module
                # keeps u.
                rows = columns(tp, self.hidden)
                weight = take_columns(copy_to(layer.update.weight, tp),
                                      rows, 0)
                bias = take_columns(copy_to(layer.update.bias, tp), rows)
                u = (u + _mm(attended.to(dtype), weight, tp)
                     + bias).to(dtype)
        return torch.cat(pooled, dim=1)


class CoAttention(nn.Module):
    """Question-guided image attention (the single variant's arithmetic,
    pooled by kernel 3 over all glimpses) and image-guided attention over
    the question tokens: a guide from ``v``'s mean, relu-summed token
    scores masked to ``-1e30``, a softmax over the tokens and the
    ``tok_out`` projection of their weighted sum. Returns ``(v_attended
    [B, G * C], q_attended [B, Q])``, f32."""

    tp = None

    def __init__(self, cfg):
        super().__init__()
        a = cfg.attention
        channels = cfg.image.output_channels
        q_features = cfg.text.output_features
        self.do_option = a.do_option
        self.dropout = a.dropout
        self.hidden = a.hidden_dim
        x_in = 2 * a.hidden_dim if a.do_option == "|" else a.hidden_dim
        self.v_conv = nn.Conv2d(channels, a.hidden_dim, 1, bias=False)
        self.q_lin = nn.Linear(q_features, a.hidden_dim)
        self.x_conv = nn.Conv2d(x_in, a.glimpses, 1)
        self.vsum_lin = nn.Linear(channels, a.hidden_dim)
        self.tok_lin = nn.Linear(q_features, a.hidden_dim)
        self.tok_out = nn.Linear(q_features, q_features)

    def forward(self, v: torch.Tensor, q: torch.Tensor, tokens: torch.Tensor,
                mask: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator], plain: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tp = self.tp
        v_proj = project_v(copy_to(dropout(v, self.dropout, generator),
                                   tp),  # site 0
                           self.v_conv, dtype)
        q_in = dropout(q, self.dropout, generator).to(dtype)  # site 1
        q_proj = (_mm(q_in, self.q_lin.weight, tp)
                  + self.q_lin.bias).to(dtype)
        cols = columns(tp, self.hidden, 2 if self.do_option == "|" else 1)
        fused = dropout(fuse(v_proj, q_proj, self.do_option), self.dropout,
                        generator, cols,
                        self.x_conv.weight.shape[1]).to(dtype)  # site 2
        att = conv_scores(fused, self.x_conv, cols, tp)
        v_att = attention_pool(v, att, plain)

        v_mean = v.float().mean(dim=(1, 2))
        guide = (_mm(v_mean.to(dtype), self.vsum_lin.weight)
                 + self.vsum_lin.bias)[:, None, :]
        tok_proj = (_mm(tokens.to(dtype), self.tok_lin.weight)
                    + self.tok_lin.bias)
        scores = torch.relu(tok_proj + guide).sum(dim=-1)  # [B, T]
        scores = torch.where(mask, scores, -1e30)
        weights = torch.softmax(scores, dim=1)
        q_att = torch.matmul(weights[:, None, :], tokens.float())[:, 0]
        q_att = _mm(q_att.to(dtype), self.tok_out.weight) + self.tok_out.bias
        return v_att, q_att

    def set_shards(self, shards) -> None:
        if self.v_conv.weight.shape[0] < self.hidden:
            self.tp = shards["model"]
