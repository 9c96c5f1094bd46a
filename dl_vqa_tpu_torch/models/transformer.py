"""Transformer pieces shared by the ViT image encoder (and, once ported,
the transformer question encoder). Port of
``dl_vqa_tpu/models/transformer.py``; so far only the layer norm.
"""

from __future__ import annotations

import torch

__all__ = ["layer_norm"]


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
