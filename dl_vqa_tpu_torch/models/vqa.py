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

Parameters carry the reference state-dict names that
``dl_vqa_tpu/utils/torch_export.py`` emits (``text.embedding``,
``text.lstm.*_l0[_reverse]``, ``image.conv{i}``, ``attention.{v_conv,
q_lin,x_conv}``, ``classifier.{lin1,lin2}``), so JAX parameters and
reference ``.pth`` states load with ``load_state_dict(strict=True)``; the
ViT's names are the port's own and are listed in ``models/vit.py``.
The JAX package trains one fused LSTM bias per direction; here
``bias_ih`` is that trainable bias and ``bias_hh`` is a constant that is
added to it (zero in imported JAX weights, torch's second draw in a fresh
init or a reference ``.pth``), so Adam moves the sum as it moves the JAX
package's ``b``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dl_vqa_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.layers import dropout, mm as _mm
from dl_vqa_tpu_torch.models.vit import LayerNorm, VitImage
from dl_vqa_tpu_torch.ops.attention_pool import attention_pool
from dl_vqa_tpu_torch.ops.conv_fused import (
    FUSED_MIN_CIN, conv_relu_pool, conv_relu_pool_stem)
from dl_vqa_tpu_torch.ops.lstm import bilstm_final_cell, lstm_scan
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


class _Text(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        t = cfg.text
        self.dropout = t.dropout
        self.embedding = nn.Embedding(cfg.num_tokens, t.embedding_features)
        self.lstm = _Lstm(t.embedding_features, t.question_features,
                          t.bidirectional)

    def forward(self, questions, lengths, dtype, plain, generator):
        embedded = self.embedding.weight[questions]
        embedded = embedded * (questions > 0).unsqueeze(-1)
        embedded = dropout(embedded, self.dropout, generator)  # site 1
        embedded = torch.tanh(embedded).to(dtype)
        if len(self.lstm.suffixes) == 2:
            return bilstm_final_cell(
                embedded, lengths, self.lstm.direction(""),
                self.lstm.direction("_reverse"), plain=plain)
        return lstm_scan(embedded, lengths, self.lstm.direction(""),
                         plain=plain)[1]


class _Image(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        i = cfg.image
        self.stride = i.stride
        self.dropout = i.dropout
        self.blocks = len(i.num_channels) - 1
        for block in range(self.blocks):
            self.add_module(f"conv{block}", nn.Conv2d(
                i.num_channels[block], i.num_channels[block + 1],
                i.kernel_size))

    def forward(self, images, dtype, plain, generator, fused=False):
        """``fused=True`` takes the blocks that never write the conv
        output: kernel 6 for stride 1 and ``Cin >= 16``, and for a narrower
        input (the RGB stem) the forward-only stem op while no gradient is
        recorded; every other block stays on the unfused path."""
        x = images.to(dtype)
        for block in range(self.blocks):
            conv = getattr(self, f"conv{block}")
            if (fused and self.stride == 1 and x.shape[-1] < FUSED_MIN_CIN
                    and not torch.is_grad_enabled()):
                x = conv_relu_pool_stem(x, conv.weight, conv.bias, plain)
            else:
                x = conv_relu_pool(x, conv.weight, conv.bias, self.stride,
                                   plain, fused)
        return dropout(x, self.dropout, generator)  # site 0


class _Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        a = cfg.attention
        self.do_option = a.do_option
        self.dropout = a.dropout
        x_in = 2 * a.hidden_dim if a.do_option == "|" else a.hidden_dim
        self.v_conv = nn.Conv2d(cfg.image.output_channels, a.hidden_dim, 1,
                                bias=False)
        self.q_lin = nn.Linear(cfg.text.output_features, a.hidden_dim)
        self.x_conv = nn.Conv2d(x_in, a.glimpses, 1)

    def forward(self, v, q, dtype, generator):
        """Glimpse logits ``[B, H, W, G]`` f32 (1x1 convs as matmuls)."""
        v_in = dropout(v, self.dropout, generator).to(dtype)  # site 2
        # Stored in the compute dtype, as the JAX model stores it; taken
        # straight from the matmul (a trip through f32 would change no bit
        # and move the [B, H, W, hidden] tensor twice more).
        v_proj = torch.matmul(v_in,
                              self.v_conv.weight[:, :, 0, 0].to(dtype).t())
        q_in = dropout(q, self.dropout, generator).to(dtype)  # site 3
        q_proj = (_mm(q_in, self.q_lin.weight) + self.q_lin.bias).to(dtype)
        q_tiled = q_proj[:, None, None, :]
        if self.do_option == "*":
            fused = torch.relu(v_proj * q_tiled)
        elif self.do_option == "+":
            fused = torch.relu(v_proj + q_tiled)
        else:  # '|'
            fused = torch.relu(torch.cat(
                [v_proj, q_tiled.expand_as(v_proj)], dim=-1))
        fused = dropout(fused, self.dropout, generator)  # site 4
        return _mm(fused, self.x_conv.weight[:, :, 0, 0]) + self.x_conv.bias


class _Classifier(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        combined = (cfg.attention.glimpses * cfg.image.output_channels
                    + cfg.text.output_features)
        self.dropout = cfg.classifier.dropout
        self.lin1 = nn.Linear(combined, cfg.classifier.hidden_dim)
        self.lin2 = nn.Linear(cfg.classifier.hidden_dim, cfg.max_answers)

    def forward(self, x, dtype, generator):
        x = dropout(x, self.dropout, generator).to(dtype)  # site 5
        x = torch.relu(_mm(x, self.lin1.weight) + self.lin1.bias)
        x = dropout(x, self.dropout, generator).to(dtype)  # site 6
        return _mm(x, self.lin2.weight) + self.lin2.bias


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
            self.text = _Text(cfg)
            self.image = (VitImage(cfg) if cfg.image.encoder == "vit"
                          else _Image(cfg))
            self.attention = _Attention(cfg)
            self.classifier = _Classifier(cfg)
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self._init_weights(generator)
        self.to(device)
        self.eval()

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        """torch's layer defaults, as ``dl_vqa_tpu/models/initializers.py``
        mirrors them: U(+-1/sqrt(fan_in)) for convs and linears, U(+-1/
        sqrt(H)) for every LSTM tensor, N(0, 1) embeddings with row 0
        zero; for the ViT also ``pos ~ N(0, 0.02^2)``, layer-norm scale 1
        and bias 0, as ``init_vit_image`` has them."""
        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                module.weight.uniform_(-bound, bound, generator=gen)
                if module.bias is not None:
                    module.bias.uniform_(-bound, bound, generator=gen)
        bound = 1.0 / math.sqrt(self.cfg.text.question_features)
        for p in self.text.lstm.parameters():
            p.uniform_(-bound, bound, generator=gen)
        self.text.embedding.weight.normal_(generator=gen)
        self.text.embedding.weight[0] = 0.0
        if isinstance(self.image, VitImage):
            self.image.pos.normal_(0.0, 0.02, generator=gen)
            for module in self.image.modules():
                if isinstance(module, LayerNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()

    def forward(self, images: torch.Tensor, questions: torch.Tensor,
                lengths: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                compute_dtype: torch.dtype = torch.float32,
                plain_ops: bool = False,
                fused_ops: bool = False) -> torch.Tensor:
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
        agree.
        """
        if train and generator is None:
            raise ValueError("train=True requires a dropout generator")
        if not train:
            generator = None
        dtype = compute_dtype
        if images.dtype == torch.uint8:
            mean = torch.as_tensor(IMAGENET_MEAN, dtype=dtype,
                                   device=images.device)
            std = torch.as_tensor(IMAGENET_STD, dtype=dtype,
                                  device=images.device)
            images = (images.to(dtype) / 255.0 - mean) / std

        v = self.image(images, dtype, plain_ops, generator,
                       fused_ops).float()
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
        q = self.text(questions, lengths, dtype, plain_ops, generator).float()
        att = self.attention(v, q, dtype, generator)
        pooled = attention_pool(v, att, plain_ops)
        return self.classifier(torch.cat([pooled, q], dim=1), dtype,
                               generator)
