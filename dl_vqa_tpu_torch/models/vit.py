"""ViT image encoder (``image.encoder == "vit"``): the dense branch of
``dl_vqa_tpu/models/vit.py`` as a PyTorch module.

``images [B, H, W, 3]`` -> feature grid ``[B, g, g, D]`` (``g = image_size
// patch_size``) in the compute dtype, which slots into the same L2 norm,
glimpse attention and classifier as the CNN's grid. Patch embedding, a
learned position table, ``num_layers`` pre-LN blocks (attention and a ReLU
MLP of width 4 D, each with a residual) and a final layer norm.

The numerics are those of the JAX model on its accelerator path:

- patch embed as the stride-P conv computes it: the product of operands
  rounded to the compute dtype is itself rounded to the compute dtype
  before the f32 bias and position adds, and the sum is cast to the
  compute dtype. The weight is ``[D, P * P * 3]`` here, the transpose of
  the JAX ``[P * P * 3, D]`` in ``(p_row, p_col, channel)`` order;
- every other product is an f32 result of operands rounded to the compute
  dtype, rounded only where the JAX code casts;
- the attention core is kernel 4 in eval and in training, with kernel 5
  as its backward (:func:`dl_vqa_tpu_torch.ops.vit_attention.vit_attention`),
  on the packed qkv projection.

State-dict names (the JAX package's exporter refuses this family, so the
port chooses them): ``image.patch_embed.{weight, bias}``, ``image.pos``,
``image.final_ln.{weight, bias}`` and per block ``image.blocks.{i}.{ln1,
ln2}.{weight, bias}`` and ``image.blocks.{i}.{qkv, out, mlp_in,
mlp_out}.{weight, bias}``; linear weights are ``[out, in]``. The JAX tree
stacks the blocks' leaves on a leading ``[L]`` axis (``image.layers.*``);
``utils/params.py`` unstacks and stacks them.

Left out, as the JAX options they belong to are not ported: MoE blocks,
the int8 projections and their calibration sink, the pipeline and
sequence contexts, and the JAX model's other attention branch (weights
normalised in the compute dtype), which it takes off the accelerator and
for heads that are no multiple of 64: here every head size runs the
kernels' arithmetic, and on the GPU the kernels take heads of 64 only and
raise for others.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.layers import dropout as _dropout, mm as _mm
from dl_vqa_tpu_torch.models.transformer import layer_norm
from dl_vqa_tpu_torch.ops.vit_attention import vit_attention
from dl_vqa_tpu_torch.ops.vit_mlp_fused import fused_ln_mlp

__all__ = ["VitImage", "VitBlock", "LayerNorm", "patch_embed"]


class LayerNorm(nn.Module):
    """Scale (``weight``) and ``bias`` of a layer norm; scale 1, bias 0."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


def patch_embed(images: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, patch_size: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``images [B, H, W, 3]`` (H, W multiples of the patch) -> f32 ``[B,
    gh * gw, D]``: the patches in ``(p_row, p_col, channel)`` order times
    ``weight^T``, rounded to ``dtype``, plus the f32 bias."""
    batch, height, width, _ = images.shape
    gh, gw = height // patch_size, width // patch_size
    patches = images.to(dtype).reshape(batch, gh, patch_size, gw, patch_size, 3)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
        batch, gh * gw, patch_size * patch_size * 3)
    return _mm(patches, weight).to(dtype).float() + bias


class VitBlock(nn.Module):
    """One pre-LN block: ``x + drop(out(attention(qkv(ln1(x)))))``, then
    ``x + drop(mlp_out(relu(mlp_in(ln2(x)))))``."""

    def __init__(self, dim: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.ln1 = LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)
        self.ln2 = LayerNorm(dim)
        self.mlp_in = nn.Linear(dim, 4 * dim)
        self.mlp_out = nn.Linear(4 * dim, dim)

    def forward(self, x, dtype, plain, generator, fused=False):
        hidden = self.ln1(x)
        qkv = (_mm(hidden, self.qkv.weight) + self.qkv.bias).to(dtype)
        att = vit_attention(qkv, self.num_heads, plain)
        att = (_mm(att, self.out.weight) + self.out.bias).to(dtype)
        x = x + _dropout(att, self.dropout, generator)        # site 21 + 2i
        if fused and generator is None and not torch.is_grad_enabled():
            # Kernel 8: forward only and without dropout, and it adds the
            # residual before the one cast where the lines below round the
            # MLP output first.
            return fused_ln_mlp(
                x, self.ln2.weight, self.ln2.bias, self.mlp_in.weight,
                self.mlp_in.bias, self.mlp_out.weight, self.mlp_out.bias,
                plain)
        hidden = self.ln2(x)
        hidden = torch.relu(
            _mm(hidden, self.mlp_in.weight) + self.mlp_in.bias).to(dtype)
        mlp = (_mm(hidden, self.mlp_out.weight) + self.mlp_out.bias).to(dtype)
        return x + _dropout(mlp, self.dropout, generator)      # site 22 + 2i


class VitImage(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        i = cfg.image
        dim = i.output_channels
        if dim % i.num_heads:
            raise ValueError(f"model dim {dim} does not split into "
                             f"{i.num_heads} heads")
        grid = cfg.image_size // i.patch_size
        self.patch_size = i.patch_size
        self.dropout = i.dropout
        self.patch_embed = nn.Linear(i.patch_size * i.patch_size * 3, dim)
        self.pos = nn.Parameter(torch.empty(grid * grid, dim))
        self.blocks = nn.ModuleList(
            VitBlock(dim, i.num_heads, i.dropout) for _ in range(i.num_layers))
        self.final_ln = LayerNorm(dim)

    def forward(self, images: torch.Tensor, dtype: torch.dtype, plain: bool,
                generator: Optional[torch.Generator],
                fused: bool = False) -> torch.Tensor:
        batch, height, width, _ = images.shape
        p = self.patch_size
        gh, gw = height // p, width // p
        if gh * gw > self.pos.shape[0]:
            raise ValueError(
                f"Patch grid {gh}x{gw} ({gh * gw} tokens) exceeds the "
                f"positional table size {self.pos.shape[0]}; the model was "
                f"initialized for image_size/patch_size = "
                f"{int(self.pos.shape[0] ** 0.5)} patches per side.")
        x = patch_embed(images[:, :gh * p, :gw * p], self.patch_embed.weight,
                        self.patch_embed.bias, p, dtype)
        x = (x + self.pos[:gh * gw]).to(dtype)
        x = _dropout(x, self.dropout, generator)               # site 20
        for block in self.blocks:
            x = block(x, dtype, plain, generator, fused)
        x = self.final_ln(x)
        return x.reshape(batch, gh, gw, x.shape[-1])
