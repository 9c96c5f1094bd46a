"""VqaNet ("Show, Ask, Attend, and Answer") as a PyTorch module: the
forward of :func:`dl_vqa_tpu.models.vqa.apply`, eval and train (dropout
at the same sites: seven with the CNN image encoder; the ViT has one
after the position add and two a block in place of the CNN's one),
differentiable through the port's kernels.

Same computation and the same mixed precision as the JAX model: images
NHWC; conv blocks in the compute dtype, or the ViT encoder of
:mod:`dl_vqa_tpu_torch.models.vit` (``image.encoder == "vit"``), whose
``[B, g, g, D]`` grid takes the conv grid's place; L2 channel norm in f32
(``v / (||v|| + 1e-12)``); embedding (id 0 -> zero) -> tanh -> masked
bi-LSTM final cell states; '+', '*' or '|' fused single attention with
the projections stored in the compute dtype; glimpse softmax pooling in
f32; a two-layer classifier over ``concat([pooled, q])``; f32 logits.
Matmul operands are in the compute dtype and their products accumulate in
f32; a result is rounded to the compute dtype only where the JAX model
rounds it (the attention's two projections).

The variants of ``encode_text`` and ``apply`` are built from the config as
there: the transformer question encoder (``text.encoder ==
"transformer"``, :mod:`dl_vqa_tpu_torch.models.transformer`) in place of
the bi-LSTM, and stacked attention or co-attention
(:mod:`dl_vqa_tpu_torch.models.fusion`) in place of the single one.
Co-attention reads the text encoder's per-token states; with the LSTM
those come, with the pooled cells, from one f32 recurrence (the JAX
package's token scan), and the classifier reads ``[pooled,
q_attended]``.

Parameters carry the reference state-dict names that
``dl_vqa_tpu/utils/torch_export.py`` emits (``text.embedding``,
``text.lstm.*_l0[_reverse]``, ``image.conv{i}``, ``attention.{v_conv,
q_lin,x_conv}``, ``classifier.{lin1,lin2}``), so JAX parameters and
reference ``.pth`` states load with ``load_state_dict(strict=True)``; the
ViT's names are the port's own and are listed in ``models/vit.py``.
The JAX package trains one fused LSTM bias per direction; here
``bias_ih`` is that trainable bias and ``bias_hh`` is a constant that is
added to it (zero in imported JAX weights, torch's second draw in a fresh
init or a reference ``.pth``; the train loop folds it into ``bias_ih``
first, ``_Lstm.fold_biases``), so Adam moves the sum as it moves the JAX
package's ``b``.

Cut by :func:`dl_vqa_tpu_torch.parallel.tensor.shard_model` for a mesh
with 'model' or 'expert' axes, each module holds this rank's shards and
sums over its group (``set_shards``): the embedding's rows, the
attention's projections and glimpse logits, the classifier, the ViT's and
the transformer's blocks, the experts; the rest runs whole on every rank.
Under 'stage' the ViT holds its stage's blocks and runs them through the
pipeline.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.fusion import (
    CoAttention, StackedAttention, conv_scores, fuse, project_v)
from dl_vqa_tpu_torch.models.layers import (
    dropout, mm as _mm, normalize_images)
from dl_vqa_tpu_torch.models.transformer import LayerNorm, TransformerText
from dl_vqa_tpu_torch.models.vit import VitImage
from dl_vqa_tpu_torch.ops.moe import MoeMlp
from dl_vqa_tpu_torch.ops.attention_pool import attention_pool
from dl_vqa_tpu_torch.ops.conv_fused import (
    FUSED_MIN_CIN, conv_relu_pool, conv_relu_pool_stem)
from dl_vqa_tpu_torch.ops.conv_int8 import (
    int8_stem_forward, with_calibrated_scales)
from dl_vqa_tpu_torch.ops.lstm import (
    bilstm_final_cell, bilstm_tokens_and_final_cell, lstm_scan,
    lstm_scan_outputs_final)
from dl_vqa_tpu_torch.ops.vit_int8 import with_calibrated_vit_scales
from dl_vqa_tpu_torch.parallel.tensor import (
    columns, copy_to, reduce_from, vocab_lookup)
from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["VqaNet", "dropout"]


class _Lstm(nn.Module):
    """Parameter holder with ``nn.LSTM``'s names for one layer. Only
    ``bias_ih`` of the two biases is trained (see the module docstring)."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool):
        super().__init__()
        self.suffixes = ("", "_reverse") if bidirectional else ("",)
        for s in self.suffixes:
            for name, shape in (("weight_ih", (4 * hidden, input_size)),
                                ("weight_hh", (4 * hidden, hidden)),
                                ("bias_ih", (4 * hidden,)),
                                ("bias_hh", (4 * hidden,))):
                self.register_parameter(f"{name}_l0{s}", nn.Parameter(
                    torch.empty(shape), requires_grad=name != "bias_hh"))

    def direction(self, suffix: str) -> dict:
        """One direction's weights for ``ops.lstm``; the two biases add."""
        def p(name):
            return getattr(self, f"{name}_l0{suffix}")

        return {"weight_ih": p("weight_ih"), "weight_hh": p("weight_hh"),
                "bias": p("bias_ih") + p("bias_hh")}

    @torch.no_grad()
    def fold_biases(self) -> None:
        """Move ``bias_hh`` into ``bias_ih``, leaving ``bias_hh`` zero: the
        same sum (the forward gives the same bits), held as the JAX model
        and the npz checkpoints hold it, so a run restored from a
        checkpoint continues from the state it saved."""
        for s in self.suffixes:
            hh = getattr(self, f"bias_hh_l0{s}")
            getattr(self, f"bias_ih_l0{s}").add_(hh)
            hh.zero_()


class _Text(nn.Module):
    vocab = None  # the 'model' Shard of the embedding's rows, if split

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        t = cfg.text
        self.dropout = t.dropout
        self.num_tokens = cfg.num_tokens
        self.embedding = nn.Embedding(cfg.num_tokens, t.embedding_features)
        self.lstm = _Lstm(t.embedding_features, t.question_features,
                          t.bidirectional)

    def forward(self, questions, lengths, dtype, plain, generator,
                need_tokens=False):
        """``(pooled [B, F], tokens [B, T, F] or None, mask [B, T] or
        None)``, as the JAX model's ``encode_text``: the tokens and their
        mask only where ``need_tokens`` (co-attention), and then the pooled
        final cells ride the same recurrence, in f32 as the JAX package
        runs it (kernel A's f32 mode); else the final cells of the
        recurrence in the compute dtype (kernel 1, or A in training)."""
        embedded = vocab_lookup(self.embedding.weight, questions, self.vocab)
        embedded = embedded * (questions > 0).unsqueeze(-1)
        embedded = dropout(embedded, self.dropout, generator)  # site 1
        embedded = torch.tanh(embedded).to(dtype)
        bidirectional = len(self.lstm.suffixes) == 2
        fwd = self.lstm.direction("")
        if need_tokens:
            seq = questions.shape[1]
            mask = (torch.arange(seq, device=questions.device)[None, :]
                    < lengths.to(questions.device)[:, None])
            if bidirectional:
                tokens, pooled = bilstm_tokens_and_final_cell(
                    embedded, lengths, fwd, self.lstm.direction("_reverse"),
                    plain=plain)
            else:
                states, pooled = lstm_scan_outputs_final(
                    embedded, lengths, fwd, plain=plain)
                tokens = states * mask[..., None]
            return pooled, tokens, mask
        if bidirectional:
            return bilstm_final_cell(
                embedded, lengths, fwd, self.lstm.direction("_reverse"),
                plain=plain), None, None
        return lstm_scan(embedded, lengths, fwd, plain=plain)[1], None, None

    def set_shards(self, shards) -> None:
        if self.embedding.weight.shape[0] < self.num_tokens:
            self.vocab = shards["model"]


class _Image(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        i = cfg.image
        self.stride = i.stride
        self.dropout = i.dropout
        self.blocks = len(i.num_channels) - 1
        self.quant = i  # store_dtype and quant_scales (VqaNet.configure)
        for block in range(self.blocks):
            self.add_module(f"conv{block}", nn.Conv2d(
                i.num_channels[block], i.num_channels[block + 1],
                i.kernel_size))

    def convs(self):
        return [getattr(self, f"conv{block}") for block in range(self.blocks)]

    def forward(self, images, dtype, plain, generator, fused=False):
        """Dispatch on ``image.store_dtype`` as the JAX model does:
        ``int8`` runs the W8A8 stem (:func:`int8_stem_forward`), ``f8e4m3``
        stores every block's activations in e4m3 and takes precedence over
        ``fused``. ``fused=True`` takes the blocks that never write the
        conv output: kernel 6 for stride 1 and ``Cin >= 16``, and for a
        narrower input (the RGB stem) the forward-only stem op while no
        gradient is recorded; every other block stays on the unfused
        path."""
        if self.quant.store_dtype == "int8":
            x = int8_stem_forward(self.convs(), images,
                                  self.quant.quant_scales, self.stride,
                                  dtype, plain)
            return dropout(x, self.dropout, generator)  # site 0
        f8_store = self.quant.store_dtype == "f8e4m3"
        x = images.to(dtype)
        for conv in self.convs():
            if (fused and not f8_store and self.stride == 1
                    and x.shape[-1] < FUSED_MIN_CIN
                    and not torch.is_grad_enabled()):
                x = conv_relu_pool_stem(x, conv.weight, conv.bias, plain)
            else:
                x = conv_relu_pool(x, conv.weight, conv.bias, self.stride,
                                   plain, fused, f8_store)
        return dropout(x, self.dropout, generator)  # site 0


class _Attention(nn.Module):
    """Under 'model' (``tp``, :meth:`set_shards`) ``v_conv`` and ``q_lin``
    are column-parallel and ``x_conv`` row-parallel: each rank fuses its
    columns of both projections, multiplies them by its rows of the
    replicated ``x_conv`` weight, the ranks sum the f32 partial logits and
    the bias is added once."""

    tp = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        a = cfg.attention
        self.do_option = a.do_option
        self.dropout = a.dropout
        self.hidden = a.hidden_dim
        x_in = 2 * a.hidden_dim if a.do_option == "|" else a.hidden_dim
        self.v_conv = nn.Conv2d(cfg.image.output_channels, a.hidden_dim, 1,
                                bias=False)
        self.q_lin = nn.Linear(cfg.text.output_features, a.hidden_dim)
        self.x_conv = nn.Conv2d(x_in, a.glimpses, 1)

    def set_shards(self, shards) -> None:
        if self.v_conv.weight.shape[0] < self.hidden:
            self.tp = shards["model"]

    def forward(self, v, q, dtype, generator):
        """Glimpse logits ``[B, H, W, G]`` f32 (1x1 convs as matmuls)."""
        tp = self.tp
        v_proj = project_v(copy_to(dropout(v, self.dropout, generator),
                                   tp),  # site 2
                           self.v_conv, dtype)
        q_in = dropout(q, self.dropout, generator).to(dtype)  # site 3
        q_proj = (_mm(q_in, self.q_lin.weight, tp)
                  + self.q_lin.bias).to(dtype)
        cols = columns(tp, self.hidden, 2 if self.do_option == "|" else 1)
        fused = dropout(fuse(v_proj, q_proj, self.do_option), self.dropout,
                        generator, cols,
                        self.x_conv.weight.shape[1])  # site 4
        return conv_scores(fused, self.x_conv, cols, tp)


class _Classifier(nn.Module):
    """Under 'model' (``tp``) ``lin1`` is column-parallel and ``lin2``
    row-parallel: the ranks sum their f32 partial logits, then
    ``lin2.bias`` is added once."""

    tp = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        combined = (cfg.attention.glimpses * cfg.image.output_channels
                    + cfg.text.output_features)
        self.dropout = cfg.classifier.dropout
        self.hidden = cfg.classifier.hidden_dim
        self.lin1 = nn.Linear(combined, cfg.classifier.hidden_dim)
        self.lin2 = nn.Linear(cfg.classifier.hidden_dim, cfg.max_answers)

    def set_shards(self, shards) -> None:
        if self.lin1.weight.shape[0] < self.hidden:
            self.tp = shards["model"]

    def forward(self, x, dtype, generator):
        tp = self.tp
        x = dropout(x, self.dropout, generator).to(dtype)  # site 5
        x = torch.relu(_mm(x, self.lin1.weight, tp) + self.lin1.bias)
        x = dropout(x, self.dropout, generator, columns(tp, self.hidden),
                    self.hidden).to(dtype)  # site 6
        return reduce_from(_mm(x, self.lin2.weight), tp) + self.lin2.bias


class VqaNet(nn.Module):
    """The reference-parity VQA model.

    ``device``: where the parameters live, the GPU unless the caller
    passes another (``"cpu"`` in the CPU tests). ``generator``: the CPU
    ``torch.Generator`` the torch-default initial weights are drawn from
    (seed 0 when omitted); the draws happen on the CPU, so a seed gives
    the same weights on every device.
    """

    def __init__(self, cfg: ModelConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg.check_ported()
        device = resolve_device(device)
        self.cfg = cfg
        # Built on the meta device, so layer constructors draw nothing
        # from the global RNG; every weight comes from `generator`.
        with torch.device("meta"):
            self.text = (TransformerText(cfg)
                         if cfg.text.encoder == "transformer" else _Text(cfg))
            self.image = (VitImage(cfg) if cfg.image.encoder == "vit"
                          else _Image(cfg))
            self.attention = {
                "single": _Attention, "stacked": StackedAttention,
                "co": CoAttention}[cfg.attention.variant](cfg)
            self.classifier = _Classifier(cfg)
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self._init_weights(generator)
        self.to(device)
        self.eval()

    def configure(self, cfg: ModelConfig) -> None:
        """Take ``cfg``, which may differ from the model's configuration in
        ``image.store_dtype`` and ``image.quant_scales`` only (a serving
        mode and its calibrated scales): the weights stay."""
        import dataclasses

        same = dataclasses.replace(cfg, image=dataclasses.replace(
            cfg.image, store_dtype=self.cfg.image.store_dtype,
            quant_scales=self.cfg.image.quant_scales))
        if same != self.cfg:
            raise ValueError("configure changes image.store_dtype and "
                             "image.quant_scales only")
        cfg.check_ported()
        self.cfg = cfg
        self.image.quant = cfg.image

    def int8_calibrated(self, images, dtype: torch.dtype = torch.bfloat16
                        ) -> ModelConfig:
        """The model's configuration in the int8 mode, with the scales
        calibrated on ``images`` (``[B, H, W, 3]``): one a conv block for
        the CNN (:func:`~dl_vqa_tpu_torch.ops.conv_int8.
        calibrate_stem_scales`), four a block for the ViT
        (:func:`~dl_vqa_tpu_torch.ops.vit_int8.calibrate_vit_scales`)."""
        calibrate = (with_calibrated_vit_scales
                     if self.cfg.image.encoder == "vit"
                     else with_calibrated_scales)
        return calibrate(self.cfg, self, images, dtype=dtype)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """torch's layer defaults, as ``dl_vqa_tpu/models/initializers.py``
        mirrors them: U(+-1/sqrt(fan_in)) for convs and linears, U(+-1/
        sqrt(H)) for every LSTM tensor, N(0, 1) embeddings with row 0
        zero; for the ViT and the transformer text encoder also ``pos ~
        N(0, 0.02^2)``, layer-norm scale 1 and bias 0, as
        ``init_vit_image`` and ``init_transformer_text`` have them."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                module.weight.uniform_(-bound, bound, generator=gen)
                if module.bias is not None:
                    module.bias.uniform_(-bound, bound, generator=gen)
        if isinstance(self.text, _Text):
            bound = 1.0 / math.sqrt(self.cfg.text.question_features)
            for p in self.text.lstm.parameters():
                p.uniform_(-bound, bound, generator=gen)
        self.text.embedding.weight.normal_(generator=gen)
        self.text.embedding.weight[0] = 0.0
        for part in (self.image, self.text):
            if hasattr(part, "pos"):
                part.pos.normal_(0.0, 0.02, generator=gen)
        for module in self.modules():
            if isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, MoeMlp):
                module.init_weights(gen)

    def forward(self, images: torch.Tensor, questions: torch.Tensor,
                lengths: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                compute_dtype: torch.dtype = torch.float32,
                plain_ops: bool = False,
                fused_ops: bool = False,
                aux_sink: Optional[list] = None) -> torch.Tensor:
        """``images [B, H, W, 3]`` (uint8 pixels or normalised floats),
        ``questions [B, T]`` int ids, ``lengths [B]`` -> ``[B,
        max_answers]`` f32 logits.

        ``train=True`` applies dropout at the sites of the JAX model,
        drawn from ``generator`` in the order the forward reaches them
        (the image encoder's first, then the text's, the attention's and
        the classifier's); the generator must live on the inputs' device.
        ``plain_ops=True`` runs every hand kernel's plain PyTorch version
        whatever the device, forward and backward: the oracle the kernel
        path is held to. ``fused_ops=True`` flips the image encoder to the
        fused ops: the CNN's conv blocks to kernel 6 and, while no gradient
        is recorded, its stem to kernel 7 and the second half of every ViT
        block to kernel 8 (with ``plain_ops`` their plain versions, on any
        device). The fused ops round once where the unfused path rounds
        twice, so in bf16 the logits move by those roundings; in f32 they
        agree. ``aux_sink``, a list, receives the factors ``(frac,
        mean_prob)`` of the balance loss of each MoE block of the ViT
        (``image.moe_experts > 0``), in order, where the JAX model's
        ``aux_sink`` receives the loss (:func:`~dl_vqa_tpu_torch.ops.moe.
        balance_loss` of them); the logits do not depend on it.
        """
        if train and generator is None:
            raise ValueError("train=True requires a dropout generator")
        if not train:
            generator = None
        dtype = compute_dtype
        self.cfg.check_ported(train=train)
        images = normalize_images(images, dtype)

        if self.cfg.image.encoder == "vit":
            v = self.image(images, dtype, plain_ops, generator, fused_ops,
                           aux_sink=aux_sink)
        else:
            v = self.image(images, dtype, plain_ops, generator, fused_ops)
        v = v.float()
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
        variant = self.cfg.attention.variant
        q, tokens, mask = self.text(questions, lengths, dtype, plain_ops,
                                    generator, need_tokens=variant == "co")
        q = q.float()
        if variant == "single":
            att = self.attention(v, q, dtype, generator)
            pooled = attention_pool(v, att, plain_ops)
        elif variant == "stacked":
            pooled = self.attention(v, q, dtype, generator, plain_ops)
        else:
            pooled, q = self.attention(v, q, tokens, mask, dtype, generator,
                                       plain_ops)
        return self.classifier(torch.cat([pooled, q], dim=1), dtype,
                               generator)
