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

__all__ = ["StackedAttention", "CoAttention", "fuse", "project_v"]


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


class StackedAttention(nn.Module):
    """SAN-style stacked attention: each glimpse scores the grid against
    the query ``u``, pools ``v`` by the softmax of its scores (kernel 3 at
    one glimpse) and, but for the last, adds ``update(attended)`` to ``u``
    (kept in the compute dtype). Returns the glimpses' pooled features
    ``[B, G * C]`` f32."""

    def __init__(self, cfg):
        super().__init__()
        a = cfg.attention
        channels = cfg.image.output_channels
        self.do_option = a.do_option
        self.dropout = a.dropout
        x_in = 2 * a.hidden_dim if a.do_option == "|" else a.hidden_dim
        self.v_conv = nn.Conv2d(channels, a.hidden_dim, 1, bias=False)
        self.q_lin = nn.Linear(cfg.text.output_features, a.hidden_dim)
        self.layers = nn.ModuleList(
            _Glimpse(x_in, channels, a.hidden_dim, g + 1 == a.glimpses)
            for g in range(a.glimpses))

    def forward(self, v: torch.Tensor, q: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator], plain: bool = False
                ) -> torch.Tensor:
        v_proj = project_v(dropout(v, self.dropout, generator),  # site 0
                           self.v_conv, dtype)
        q_in = dropout(q, self.dropout, generator).to(dtype)  # site 1
        u = (_mm(q_in, self.q_lin.weight) + self.q_lin.bias).to(dtype)
        pooled = []
        for layer in self.layers:
            fused = fuse(v_proj, u, self.do_option)
            scores = (_mm(fused, layer.score.weight[:, :, 0, 0])
                      + layer.score.bias)  # [B, H, W, 1] f32
            attended = attention_pool(v, scores, plain)  # [B, C] f32
            pooled.append(attended)
            if layer.update is not None:
                # f32 sum, stored in the compute dtype as the JAX module
                # keeps u.
                u = (u + _mm(attended.to(dtype), layer.update.weight)
                     + layer.update.bias).to(dtype)
        return torch.cat(pooled, dim=1)


class CoAttention(nn.Module):
    """Question-guided image attention (the single variant's arithmetic,
    pooled by kernel 3 over all glimpses) and image-guided attention over
    the question tokens: a guide from ``v``'s mean, relu-summed token
    scores masked to ``-1e30``, a softmax over the tokens and the
    ``tok_out`` projection of their weighted sum. Returns ``(v_attended
    [B, G * C], q_attended [B, Q])``, f32."""

    def __init__(self, cfg):
        super().__init__()
        a = cfg.attention
        channels = cfg.image.output_channels
        q_features = cfg.text.output_features
        self.do_option = a.do_option
        self.dropout = a.dropout
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
        v_proj = project_v(dropout(v, self.dropout, generator),  # site 0
                           self.v_conv, dtype)
        q_in = dropout(q, self.dropout, generator).to(dtype)  # site 1
        q_proj = (_mm(q_in, self.q_lin.weight) + self.q_lin.bias).to(dtype)
        fused = dropout(fuse(v_proj, q_proj, self.do_option), self.dropout,
                        generator).to(dtype)  # site 2
        att = _mm(fused, self.x_conv.weight[:, :, 0, 0]) + self.x_conv.bias
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
