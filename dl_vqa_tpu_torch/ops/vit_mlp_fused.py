"""Layer norm + ReLU MLP + residual of a ViT block as one op, forward only.

Port of ``experiments/probe_vit_mlp_fused.py::fused_ln_mlp`` and its
``reference``. Kernel 8 (``csrc/vit_mlp_fused.cu``) replaces ``::_kernel``.
Per token row, with the weights in the port's ``[out, in]`` layout:
``ln = cast(layer_norm(x))`` (statistics in f32, eps 1e-5); ``h =
cast(relu(f32(ln W1^T) + b1))``; ``out = cast(f32(x) + f32(h W2^T) + b2)``:
products of operands rounded to ``x``'s dtype with f32 sums, and the
residual joins the f32 sum before the one cast.

That last step is where the op and the model's block part: ``VitBlock``
(as ``dl_vqa_tpu/models/vit.py``) rounds the MLP output to the compute
dtype before the residual add, the kernel (as the TPU kernel) after. In
f32 the two agree; in bf16 they differ by that rounding, once a block.

What bounds the kernel on this card is operations: 105 GFLOP a layer at
batch 512 (0.11 ms at the bf16 tensor cores' rate) against 0.1 GB moved.
The unfused block moves ``ln``, the ``[B, S, 4 D]`` hidden tensor and the
MLP output through device memory, with f32 copies around each product;
here ``x`` is read and ``out`` is written. The source note says how.
"""

from __future__ import annotations

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["fused_ln_mlp_reference", "fused_ln_mlp_cuda", "fused_ln_mlp",
           "KERNEL_DIMS", "HIDDEN_MULTIPLE"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DIMS = (64, 128, 256)  # model widths csrc/vit_mlp_fused.cu is built for
HIDDEN_MULTIPLE = 64          # its walk over the hidden units takes 64 a step
_EPS = 1e-5


def fused_ln_mlp_reference(x: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8, in the kernel's order of operations.
    ``x [..., D]``, ``w1 [F, D]``, ``w2 [D, F]``; the products are f32
    products of operands rounded to ``x``'s dtype."""
    dtype = x.dtype
    x32 = x.float()
    centred = x32 - x32.mean(dim=-1, keepdim=True)
    var = (centred * centred).mean(dim=-1, keepdim=True)
    ln = (centred * torch.rsqrt(var + _EPS) * ln_scale.float()
          + ln_bias.float()).to(dtype)
    hidden = torch.relu(
        torch.matmul(ln.float(), w1.to(dtype).float().t()) + b1.float()
    ).to(dtype)
    mlp = torch.matmul(hidden.float(), w2.to(dtype).float().t()) + b2.float()
    return (x32 + mlp).to(dtype)


def fused_ln_mlp_cuda(x: torch.Tensor, ln_scale: torch.Tensor,
                      ln_bias: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """Kernel 8 on ``x``'s CUDA device; raises on any input it does not
    take. The weights are rounded to ``x``'s dtype here, once a call."""
    dim = x.shape[-1] if x.dim() else 0
    hidden = w1.shape[0] if w1.dim() == 2 else 0
    shapes = {"ln_scale": (ln_scale, (dim,)), "ln_bias": (ln_bias, (dim,)),
              "w1": (w1, (hidden, dim)), "b1": (b1, (hidden,)),
              "w2": (w2, (dim, hidden)), "b2": (b2, (dim,))}
    if x.dim() < 2 or any(tuple(t.shape) != want
                          for t, want in shapes.values()):
        raise ValueError(
            "expected x [..., D], ln_scale, ln_bias, b2 [D], w1 [F, D], "
            "b1 [F], w2 [D, F]; got x " + str(tuple(x.shape)) + ", "
            + ", ".join(f"{name} {tuple(t.shape)}"
                        for name, (t, _) in shapes.items()))
    if not x.is_cuda or any(t.device != x.device for t, _ in shapes.values()):
        raise ValueError("fused_ln_mlp_cuda takes CUDA tensors on one "
                         f"device; got x on {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be one of {list(_DTYPES)}; got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if dim not in KERNEL_DIMS or hidden < 1 or hidden % HIDDEN_MULTIPLE:
        raise ValueError(
            f"kernel 8 takes D in {KERNEL_DIMS} and F a multiple of "
            f"{HIDDEN_MULTIPLE}; got D={dim}, F={hidden}")
    rows = x.numel() // dim
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernel's int32 row count")
    lib = _native.library()
    held = [t.detach().float().contiguous()
            for t in (ln_scale, ln_bias, b1, b2)]
    weights = [t.detach().to(x.dtype).contiguous() for t in (w1, w2)]
    out = torch.empty_like(x)
    code = lib.vqa_vit_mlp_fused(
        x.data_ptr(), held[0].data_ptr(), held[1].data_ptr(),
        weights[0].data_ptr(), held[2].data_ptr(), weights[1].data_ptr(),
        held[3].data_ptr(), out.data_ptr(), rows, dim, hidden,
        _DTYPES[x.dtype], _native.stream_ptr(x.device))
    _native.check("vit_mlp_fused", code)
    if rows:  # the C entry launches nothing for no row
        fused_ln_mlp_cuda.launches += 1
    return out


fused_ln_mlp_cuda.launches = 0


def fused_ln_mlp(x: torch.Tensor, ln_scale: torch.Tensor,
                 ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """``x + relu(ln(x) W1^T + b1) W2^T + b2``, forward only like the
    probe's kernel (an eval-path op without a gradient rule): it raises
    where a gradient would be recorded. Dispatch: a CPU tensor, or
    ``plain=True``, runs the plain version; any other device runs kernel
    8, which raises where it cannot launch."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ln_scale, ln_bias, w1, b1, w2, b2)):
        raise RuntimeError(
            "fused_ln_mlp is forward only: call it under torch.no_grad(), "
            "or use the block's unfused code for gradients")
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if plain or x.device.type == "cpu":
        return fused_ln_mlp_reference(*args)
    return fused_ln_mlp_cuda(*args)
