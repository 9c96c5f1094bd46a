"""ViT image encoder (``image.encoder == "vit"``): ``dl_vqa_tpu/models/vit.py``
as a PyTorch module, its dense and its mixture-of-experts blocks.

``images [B, H, W, 3]`` -> feature grid ``[B, g, g, D]`` (``g = image_size
// patch_size``) in the compute dtype, which slots into the same L2 norm,
glimpse attention and classifier as the CNN's grid. Patch embedding, a
learned position table, ``num_layers`` pre-LN blocks (attention and a ReLU
MLP of width 4 D, each with a residual) and a final layer norm. With
``image.moe_experts > 0`` every block's MLP is the mixture-of-experts FFN
of :mod:`dl_vqa_tpu_torch.ops.moe` (each expert of width 4 D), routed with
``image.moe_top_k`` and ``image.moe_capacity_factor``; each block appends
the factors of its balance loss to the ``aux_sink`` that
:meth:`VitImage.forward` is given.

The numerics are those of the JAX model on its accelerator path:

- patch embed as the stride-P conv computes it: the product of operands
  rounded to the compute dtype is itself rounded to the compute dtype
  before the f32 bias and position adds, and the sum is cast to the
  compute dtype. The weight is ``[D, P * P * 3]`` here, the transpose of
  the JAX ``[P * P * 3, D]`` in ``(p_row, p_col, channel)`` order;
- every other product is an f32 result of operands rounded to the compute
  dtype, rounded only where the JAX code casts;
- the attention core is chosen as the JAX model chooses it: for heads of
  64 n it is kernel 4 in eval and in training, with kernel 5 as its
  backward (:func:`dl_vqa_tpu_torch.ops.vit_attention.vit_attention`, their
  plain versions on the CPU), on the packed qkv projection; any other head
  takes the JAX model's other branch, which normalises the weights in the
  compute dtype (:func:`~dl_vqa_tpu_torch.ops.vit_attention.
  vit_attention_weights_normalised`), on every device, as the JAX model
  has no kernel there.

State-dict names (the JAX package's exporter refuses this family, so the
port chooses them): ``image.patch_embed.{weight, bias}``, ``image.pos``,
``image.final_ln.{weight, bias}`` and per block ``image.blocks.{i}.{ln1,
ln2}.{weight, bias}``, ``image.blocks.{i}.{qkv, out}.{weight, bias}`` and
either ``image.blocks.{i}.{mlp_in, mlp_out}.{weight, bias}`` or
``image.blocks.{i}.moe.{gate, in.weight, in.bias, out.weight, out.bias}``;
linear weights are ``[out, in]``. The JAX tree stacks the blocks' leaves
on a leading ``[L]`` axis (``image.layers.*``); ``utils/params.py``
unstacks and stacks them.

With ``image.store_dtype == "int8"`` the four products of every dense
block run as W8A8 (:func:`dl_vqa_tpu_torch.ops.vit_int8.w8a8_linear`, the
MLP hidden kept in f32 between its two), ahead of kernel 8; an amax sink
collects their inputs' amaxes for the calibration. The JAX model refuses
the int8 mode with MoE blocks, and so does the port
(``ModelConfig.check_ported``).

Under 'model' (``VitBlock.tp``, ``VitBlock.mlp_tp``) ``qkv`` and
``mlp_in`` are column-parallel, ``qkv`` by heads (this rank's ``num_heads
/ model`` heads, packed ``[q | k | v]``, which kernels 4 and 5 take as they
take a whole block's), and ``out`` and ``mlp_out`` row-parallel: their f32
partial products are summed over the ranks before the bias and before
the rounding to the compute dtype (in the int8 mode their s32 partial
products, :func:`~dl_vqa_tpu_torch.ops.vit_int8.w8a8_linear`). Where the
axis does not divide the heads, ``qkv`` and ``out`` stay whole on every
rank and only the MLP splits. A MoE block's experts split over 'expert'
and their hidden width over 'model' (:mod:`dl_vqa_tpu_torch.ops.moe`).
Kernel 8 fuses the MLP that 'model' splits: ``fused_ops`` with 'model'
above 1 raises (ROADMAP queue 2's kernel work).

Under 'seq' (:mod:`dl_vqa_tpu_torch.parallel.sequence`, set by
:meth:`VitImage.set_shards`) each rank keeps its contiguous ``S / n``
tokens after the position table and dropout site 20, runs the blocks on
them with the ring
(:func:`dl_vqa_tpu_torch.ops.ring_attention.ring_attention_qkv`) as every
block's attention core, as the JAX model takes the ring in place of its
kernel, and gathers the sequence after the final layer norm; the blocks'
dropout sites draw the whole sequence's masks and keep the rank's tokens.

Under 'stage' (a model cut by
:func:`~dl_vqa_tpu_torch.parallel.tensor.shard_model`, whose
:meth:`VitImage.set_shards` gives the ViT its pipeline context) the blocks
run through the GPipe executor (:mod:`dl_vqa_tpu_torch.parallel.pipeline`),
this rank holding the blocks of its stage; every block's dropout masks are
drawn for the whole batch first, in one process's order, and each
microbatch keeps its rows.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.layers import (
    BatchRows, Drawn, draw_masks, dropout as _dropout, mm as _mm)
from dl_vqa_tpu_torch.models.transformer import LayerNorm
from dl_vqa_tpu_torch.ops.moe import MOE_WITHOUT_ROUTING, MoeMlp
from dl_vqa_tpu_torch.ops.ring_attention import ring_attention_qkv
from dl_vqa_tpu_torch.ops.vit_attention import (
    kernel_head, vit_attention, vit_attention_weights_normalised)
from dl_vqa_tpu_torch.ops.vit_int8 import w8a8_linear
from dl_vqa_tpu_torch.ops.vit_mlp_fused import fused_ln_mlp
from dl_vqa_tpu_torch.parallel.mesh import FUSED_OPS_UNDER_MODEL
from dl_vqa_tpu_torch.parallel.pipeline import (
    INT8_WITH_STAGE, MOE_WITH_STAGE, microbatch_rows, pipeline_apply,
    stage_layers)
from dl_vqa_tpu_torch.parallel.tensor import reduce_from

__all__ = ["VitImage", "VitBlock", "LayerNorm", "patch_embed"]


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
    ``x + drop(mlp_out(relu(mlp_in(ln2(x)))))``, or with ``experts > 0``
    ``x + drop(moe(ln2(x)))``. ``tp``: the 'model' Shard when the
    attention's products are split (:meth:`set_shards`; ``num_heads`` is
    then this rank's count), ``mlp_tp`` when the MLP's are."""

    tp = None
    mlp_tp = None
    seq = None

    def __init__(self, dim: int, num_heads: int, dropout: float,
                 experts: int = 0):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.ln1 = LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)
        self.ln2 = LayerNorm(dim)
        if experts:
            self.moe = MoeMlp(dim, 4 * dim, experts)
        else:
            self.mlp_in = nn.Linear(dim, 4 * dim)
            self.mlp_out = nn.Linear(4 * dim, dim)

    def attention(self, qkv: torch.Tensor, plain: bool) -> torch.Tensor:
        """The attention core on the packed ``qkv`` in the compute dtype:
        under 'seq' the ring over this rank's tokens; else kernels 4 and 5
        for heads of 64 n (their plain versions on the CPU or with
        ``plain``), the JAX model's other branch for the rest."""
        if self.seq is not None:
            return ring_attention_qkv(qkv, self.num_heads, self.seq)
        if kernel_head(qkv.shape[-1] // (3 * self.num_heads)):
            return vit_attention(qkv, self.num_heads, plain)
        return vit_attention_weights_normalised(qkv, self.num_heads)

    def set_shards(self, shards) -> None:
        self.seq = shards.get("seq")
        if self.qkv.weight.shape[0] < 3 * self.dim:
            self.tp = shards["model"]
            self.num_heads //= self.tp.size
        if hasattr(self, "mlp_in") and \
                self.mlp_in.weight.shape[0] < 4 * self.dim:
            self.mlp_tp = shards["model"]

    def forward(self, x, dtype, plain, generator, fused=False, scales=None,
                amax_sink=None, moe=None, aux_sink=None):
        """``scales``: the block's four int8 site scales, which run its
        four products as W8A8 (:func:`w8a8_linear`, before kernel 8);
        ``amax_sink`` collects the four sites' input amaxes instead. A MoE
        block routes with ``moe = (top_k, capacity_factor)`` and appends the
        factors of its balance loss to ``aux_sink``; kernel 8 never takes
        it."""
        if fused and self.mlp_tp is not None:
            raise NotImplementedError(FUSED_OPS_UNDER_MODEL)

        def linear(h, layer, site, out_dtype, tp, row=False):
            if amax_sink is not None:
                amax_sink.append(h.float().abs().amax())
            if scales is not None:
                return w8a8_linear(h, layer.weight, layer.bias, scales[site],
                                   out_dtype, tp if row else None)
            if row:  # the ranks' partial sums, then the bias once
                return reduce_from(_mm(h, layer.weight), tp) + layer.bias
            return _mm(h, layer.weight, tp) + layer.bias

        hidden = self.ln1(x)
        qkv = linear(hidden, self.qkv, 0, torch.float32, self.tp).to(dtype)
        att = self.attention(qkv, plain)
        att = linear(att, self.out, 1, torch.float32, self.tp,
                     row=True).to(dtype)
        x = x + _dropout(att, self.dropout, generator)        # site 21 + 2i
        if hasattr(self, "moe"):
            if moe is None:
                raise ValueError(MOE_WITHOUT_ROUTING)
            mlp = self.moe(self.ln2(x), *moe, aux_sink=aux_sink)
            return x + _dropout(mlp, self.dropout, generator)  # site 22 + 2i
        if scales is not None:
            # The hidden stays f32 between the two W8A8 products.
            hidden = torch.relu(linear(self.ln2(x), self.mlp_in, 2,
                                       torch.float32, self.mlp_tp))
            mlp = linear(hidden, self.mlp_out, 3, dtype, self.mlp_tp,
                         row=True)
            return x + _dropout(mlp, self.dropout, generator)  # site 22 + 2i
        if (fused and amax_sink is None and generator is None
                and not torch.is_grad_enabled()):
            # Kernel 8: forward only and without dropout, and it adds the
            # residual before the one cast where the lines below round the
            # MLP output first.
            return fused_ln_mlp(
                x, self.ln2.weight, self.ln2.bias, self.mlp_in.weight,
                self.mlp_in.bias, self.mlp_out.weight, self.mlp_out.bias,
                plain)
        hidden = torch.relu(linear(self.ln2(x), self.mlp_in, 2,
                                   torch.float32, self.mlp_tp)).to(dtype)
        mlp = linear(hidden, self.mlp_out, 3, dtype, self.mlp_tp,
                     row=True).to(dtype)
        return x + _dropout(mlp, self.dropout, generator)      # site 22 + 2i


class VitImage(nn.Module):
    seq = None  # this rank's SequenceContext under 'seq' (set_shards)
    pipeline = None  # this rank's PipelineContext under 'stage' (likewise)

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
        self.quant = i  # store_dtype and quant_scales (VqaNet.configure)
        self.patch_embed = nn.Linear(i.patch_size * i.patch_size * 3, dim)
        self.pos = nn.Parameter(torch.empty(grid * grid, dim))
        self.blocks = nn.ModuleList(
            VitBlock(dim, i.num_heads, i.dropout, i.moe_experts)
            for _ in range(i.num_layers))
        self.final_ln = LayerNorm(dim)

    def set_shards(self, shards) -> None:
        self.seq = shards.get("seq")
        self.pipeline = shards.get("stage")

    def _pipelined(self, x, dtype, plain, generator, fused):
        """The blocks through the GPipe executor: this rank's stage's
        blocks on each microbatch of its rows (module docstring)."""
        mesh = self.pipeline.mesh
        layers = self.quant.num_layers
        mine = stage_layers(layers, mesh.size("stage"), mesh.coord("stage"))
        rows = x.shape[0]
        micro = microbatch_rows(rows, self.pipeline)
        # Every block's two sites, drawn for the whole batch in one
        # process's order; a stage keeps its blocks' masks.
        masks = draw_masks(x, self.dropout, generator, 2 * layers)
        if masks is not None:
            masks = masks[2 * mine.start:2 * mine.stop]

        def layer_fn(layer, h, m):
            j, block = layer
            source = None
            if masks is not None:
                source = Drawn([bits.narrow(0, m * micro, micro)
                                for bits in masks[2 * j:2 * j + 2]])
            return block(h, dtype, plain, source, fused)

        out = pipeline_apply(layer_fn, list(enumerate(self.blocks)),
                             x.reshape((rows // micro, micro) + x.shape[1:]),
                             mesh)
        return out.reshape(x.shape)

    def forward(self, images: torch.Tensor, dtype: torch.dtype, plain: bool,
                generator: Optional[torch.Generator],
                fused: bool = False, amax_sink: Optional[list] = None,
                aux_sink: Optional[list] = None) -> torch.Tensor:
        """``image.store_dtype == "int8"`` runs the blocks' products as
        W8A8 with their slice of ``image.quant_scales``; ``amax_sink`` (a
        list) runs the compute-dtype path and collects the four int8 sites'
        input amaxes of every block, in order (the calibration pass).
        ``aux_sink`` (a list) receives each MoE block's balance-loss
        factors ``(frac, mean_prob)`` (:func:`~dl_vqa_tpu_torch.ops.moe.
        balance_loss`), in order."""
        batch, height, width, _ = images.shape
        p = self.patch_size
        gh, gw = height // p, width // p
        if gh * gw > self.pos.shape[0]:
            raise ValueError(
                f"Patch grid {gh}x{gw} ({gh * gw} tokens) exceeds the "
                f"positional table size {self.pos.shape[0]}; the model was "
                f"initialized for image_size/patch_size = "
                f"{int(self.pos.shape[0] ** 0.5)} patches per side.")
        int8 = self.quant.store_dtype == "int8" and amax_sink is None
        if self.pipeline is not None:
            if int8:
                raise NotImplementedError(INT8_WITH_STAGE)
            if self.quant.moe_experts:
                raise NotImplementedError(MOE_WITH_STAGE)
        x = patch_embed(images[:, :gh * p, :gw * p], self.patch_embed.weight,
                        self.patch_embed.bias, p, dtype)
        x = (x + self.pos[:gh * gw]).to(dtype)
        x = _dropout(x, self.dropout, generator)               # site 20
        seq = self.seq
        if seq is not None:
            tokens = seq.tokens(x.shape[1])
            x = seq.scatter(x)
            if generator is not None:
                if not isinstance(generator, BatchRows):
                    generator = BatchRows(generator, batch, 0)
                generator = generator._replace(tokens=gh * gw,
                                               token_start=tokens.start)
        if self.pipeline is not None:
            x = self._pipelined(x, dtype, plain, generator, fused)
        else:
            moe = ((self.quant.moe_top_k, self.quant.moe_capacity_factor)
                   if self.quant.moe_experts else None)
            for idx, block in enumerate(self.blocks):
                scales = (tuple(self.quant.quant_scales[4 * idx:4 * idx + 4])
                          if int8 else None)
                x = block(x, dtype, plain, generator, fused, scales,
                          amax_sink, moe, aux_sink)
        x = self.final_ln(x)
        if seq is not None:
            x = seq.gather(x)
        return x.reshape(batch, gh, gw, x.shape[-1])
