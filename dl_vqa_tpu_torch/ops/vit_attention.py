"""ViT self-attention on the packed qkv projection, forward and backward.

Port of :mod:`dl_vqa_tpu.ops.vit_attention_pallas`. ``qkv`` is ``[B, S,
3 * H * D]``, packed as q | k | v with each part head-major, exactly as
the fused qkv product leaves it; the output is the merged ``[B, S, H *
D]``. Nothing is split or transposed before a launch. The kernels take
every head that the TPU kernels take, ``D`` a multiple of 64 (the JAX
model sends those to them, ``dl_vqa_tpu/models/vit.py::_attention``), and
walk a head 64 columns at a time; the scale ``1 / sqrt(D)`` is the f32
that the plain versions multiply by. Other heads take the JAX model's
other branch, :func:`vit_attention_weights_normalised`, on every device.

Kernel 4 (``csrc/vit_attention.cu``) replaces
``dl_vqa_tpu/ops/vit_attention_pallas.py::_attention_kernel``. Per image
and head, in this order: ``s = f32(q k^T) / sqrt(D)``; ``m = rowmax(s)``;
``e = exp(s - m)`` in f32; ``denom = rowsum(e)`` of the f32 ``e``; ``o =
f32(cast(e) v) / denom``; store ``cast(o)``. The ``[S, D]`` output is
normalised, not the ``[S, S]`` weights, so this is not
``vit_attention_qkv_reference`` of the JAX package, which normalises the
weights before the cast: in bf16 the two differ by roundings.

Kernel 5 (``csrc/vit_attention_backward.cu``) replaces
``::_attention_bwd_kernel``: from the saved ``qkv`` and the cotangent ``g
[B, S, H * D]`` it recomputes ``s, m, e, denom``, takes ``w = cast(e /
denom)`` (here the weights are normalised before the cast), ``dv = f32(w^T
g)``, ``dw = f32(g v^T)``, ``dz = cast(f32(w) (dw - rowsum(dw f32(w))))``,
``dq = f32(dz k) / sqrt(D)``, ``dk = f32(dz^T q) / sqrt(D)`` and writes
the packed ``dqkv`` like ``qkv``. In bf16 with heads of 64 up to 256
tokens it launches one grid, a block per (image, head) that runs over the
query rows for ``dq`` and then over the key rows for ``dk`` and ``dv``; in
f32, in bf16 for heads of 128 and more, and past 256 tokens, two grids
with the row statistics in a device scratch between them. All give the
same digits on every run. The f32 sums
over a head of 64 n run over its slices in order, the order of one
64 n-long sum, so a head's bits do not depend on how it is sliced; against
the plain versions they differ as at 64, by sums in another order
(``tests/test_torch_cuda.py``).

Up to 256 tokens (16 key tiles of 16) a query row's scores live in a
warp's registers. Longer sequences (the 448-px ViT's 784 tokens) take the
key-tile kernels of ``csrc/vit_attention.cuh``: the keys (for ``dk`` and
``dv`` the queries) are walked a 64-row tile at a time through a
two-stage ``cp.async`` ring, and each row statistic takes a pass of its
own (first the max, then the sums at it), so the plain versions' rounding
points hold at every length and no tile width enters the numbers.

At S = 196 what bounds both on this card is memory traffic (each reads and
writes only ``[B, S, .]`` tensors, 205 MB and 360 MB at B = 512, H = 4, D
= 64 in bf16); at S = 784 it is the products (322 and 805 GFLOP at B =
512 against 0.82 and 1.44 GB). The plain versions below write the f32
``[B, H, S, S]`` scores and weights to device memory several times over.
The source notes say what each design does about it.

:class:`VitAttention` joins the two as
``vit_attention_qkv_pallas_fused_bwd`` joins the TPU kernels: the only
residual is the packed ``qkv``. Its forward is the custom op
``vqa::vit_attention``: kernel 4 on CUDA tensors, the plain version on
CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["vit_attention_reference", "vit_attention_cuda",
           "vit_attention_backward_reference", "vit_attention_backward_cuda",
           "VitAttention", "vit_attention", "vit_attention_weights_normalised",
           "kernel_head"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SLICE = 64  # csrc/vit_attention.cuh kSlice: the kernels' heads are 64 n
ROW_SEQ = 256    # csrc/vit_attention.cuh kMaxRowSeq: a score row in registers


def kernel_head(head: int) -> bool:
    """Whether kernels 4 and 5 take heads of ``head``: the JAX model's test
    for its Pallas kernels (``head % 64 == 0``)."""
    return head > 0 and head % HEAD_SLICE == 0


def _scale(head: int) -> float:
    """``1 / sqrt(head)``, which the plain versions multiply f32 scores by
    and the kernels receive rounded to f32."""
    return 1.0 / head ** 0.5


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, S, H * D]`` -> f32 ``[B, H, S, D]``."""
    batch, seq, dim = x.shape
    return x.reshape(batch, seq, num_heads, dim // num_heads).transpose(
        1, 2).float()


def _merge(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, S, D]`` -> ``[B, S, H * D]``."""
    batch, heads, seq, head = x.shape
    return x.transpose(1, 2).reshape(batch, seq, heads * head)


def _softmax_parts(q, k, scale):
    """``(e, denom)`` of the row softmax of ``f32(q k^T) * scale``."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e, e.sum(dim=-1, keepdim=True)


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 3 or num_heads < 1 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"expected qkv [B, S, 3*H*D] for H={num_heads}; "
                         f"got {tuple(qkv.shape)}")


def vit_attention_reference(qkv: torch.Tensor, num_heads: int
                            ) -> torch.Tensor:
    """Plain version of kernel 4, in the kernel's order of operations. The
    products are f32 products of the operands as they are stored (exact
    for bf16 operands, f32 accumulation)."""
    _check_qkv(qkv, num_heads)
    dtype = qkv.dtype
    q, k, v = (_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    e, denom = _softmax_parts(q, k, 1.0 / q.shape[-1] ** 0.5)
    out = torch.matmul(e.to(dtype).float(), v) / denom
    return _merge(out.to(dtype))


def vit_attention_backward_reference(qkv: torch.Tensor, g: torch.Tensor,
                                     num_heads: int) -> torch.Tensor:
    """Plain version of kernel 5: the closed form, step for step."""
    _check_qkv(qkv, num_heads)
    dtype = qkv.dtype
    q, k, v = (_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    g = _heads(g, num_heads)
    scale = 1.0 / q.shape[-1] ** 0.5
    e, denom = _softmax_parts(q, k, scale)
    w = (e / denom).to(dtype).float()
    dv = torch.matmul(w.transpose(-1, -2), g)
    dw = torch.matmul(g, v.transpose(-1, -2))
    dz = (w * (dw - (dw * w).sum(dim=-1, keepdim=True))).to(dtype).float()
    dq = torch.matmul(dz, k) * scale
    dk = torch.matmul(dz.transpose(-1, -2), q) * scale
    return torch.cat([_merge(t.to(dtype)) for t in (dq, dk, dv)], dim=-1)


def _check_cuda(qkv: torch.Tensor, num_heads: int, what: str) -> int:
    """The head size, where the kernels take ``qkv``; raises otherwise."""
    _check_qkv(qkv, num_heads)
    batch, seq, three_dim = qkv.shape
    head = three_dim // (3 * num_heads)
    if not kernel_head(head):
        raise ValueError(f"{what} takes heads of a multiple of {HEAD_SLICE}; "
                         f"got {head}")
    if not qkv.is_cuda:
        raise ValueError(f"{what} takes CUDA tensors; got {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"qkv must be one of {list(_DTYPES)}; got "
                         f"{qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if batch > 65535 or num_heads > 65535:
        raise ValueError(f"batch {batch} or heads {num_heads} exceed the "
                         "launch grid (65535)")
    return head


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index``: below this many (image, head) pairs the
    bf16 forward spreads a head's query slabs over several blocks."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def vit_attention_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel 4 on ``qkv``'s CUDA device; raises on any input it does not
    take."""
    head = _check_cuda(qkv, num_heads, "vit_attention_cuda")
    batch, seq, three_dim = qkv.shape
    lib = _native.library()
    out = torch.empty(batch, seq, three_dim // 3, dtype=qkv.dtype,
                      device=qkv.device)
    code = lib.vqa_vit_attention(
        qkv.data_ptr(), out.data_ptr(), batch, seq, num_heads, head,
        _scale(head), _sm_count(qkv.device.index), _DTYPES[qkv.dtype],
        _native.stream_ptr(qkv.device))
    _native.check("vit_attention", code)
    if batch and seq:  # the C entry launches nothing for empty input
        vit_attention_cuda.launches += 1
    return out


vit_attention_cuda.launches = 0


def _attention_fake(qkv, num_heads):
    batch, seq, three_dim = qkv.shape
    return qkv.new_empty(batch, seq, three_dim // 3)


_native.define_op("vit_attention", "(Tensor qkv, int num_heads) -> Tensor",
                  vit_attention_reference, vit_attention_cuda,
                  _attention_fake)


def backward_grids(dtype: torch.dtype, head: int, seq: int = 0) -> int:
    """Grids a kernel-5 call launches: one for bf16 heads of 64 up to
    :data:`ROW_SEQ` tokens, two (dq, then dk and dv) for f32, for wider
    heads and for longer sequences."""
    return (1 if dtype == torch.bfloat16 and head == HEAD_SLICE
            and seq <= ROW_SEQ else 2)


def vit_attention_backward_cuda(qkv: torch.Tensor, g: torch.Tensor,
                                num_heads: int) -> torch.Tensor:
    """Kernel 5 on ``qkv``'s CUDA device; raises on any input it does not
    take."""
    head = _check_cuda(qkv, num_heads, "vit_attention_backward_cuda")
    batch, seq, three_dim = qkv.shape
    if tuple(g.shape) != (batch, seq, three_dim // 3):
        raise ValueError(f"expected g {(batch, seq, three_dim // 3)} for qkv "
                         f"{tuple(qkv.shape)}; got {tuple(g.shape)}")
    if g.device != qkv.device or g.dtype != qkv.dtype:
        raise ValueError(f"g must share qkv's device and dtype; got "
                         f"{g.device} {g.dtype}, {qkv.device} {qkv.dtype}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    lib = _native.library()
    dqkv = torch.empty_like(qkv)
    # bf16 heads of 64 up to ROW_SEQ tokens: one grid, the row statistics
    # stay in shared memory. Otherwise per query row m, denom and
    # rowsum(dw w), which the first of two grids writes and the second
    # reads.
    two_grids = backward_grids(qkv.dtype, head, seq) == 2
    stats = (torch.empty(batch, num_heads, 3, seq, dtype=torch.float32,
                         device=qkv.device) if two_grids else None)
    code = lib.vqa_vit_attention_backward(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        stats.data_ptr() if two_grids else None, batch, seq, num_heads,
        head, _scale(head), _DTYPES[qkv.dtype],
        _native.stream_ptr(qkv.device))
    _native.check("vit_attention_backward", code)
    if batch and seq:
        vit_attention_backward_cuda.launches += 2 if two_grids else 1
    return dqkv


vit_attention_backward_cuda.launches = 0


class VitAttention(torch.autograd.Function):
    """``(qkv, num_heads, plain) -> out``: ``vqa::vit_attention`` forward,
    kernel 5 backward (their plain versions for a CPU tensor or
    ``plain=True``; ``plain=True`` never calls the op). Saves the packed
    ``qkv`` and nothing else."""

    @staticmethod
    def forward(ctx, qkv, num_heads, plain):
        ctx.plain = plain or qkv.device.type == "cpu"
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv)
        return (vit_attention_reference(qkv, num_heads) if plain
                else torch.ops.vqa.vit_attention(qkv, num_heads))

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        # Autograd hands over g in the output's dtype, which is qkv's (the
        # CUDA wrapper checks it again), but not always contiguous.
        backward = (vit_attention_backward_reference if ctx.plain
                    else vit_attention_backward_cuda)
        return backward(qkv, g.contiguous(), ctx.num_heads), None, None


def vit_attention_weights_normalised(qkv: torch.Tensor, num_heads: int
                                     ) -> torch.Tensor:
    """The JAX model's other attention branch
    (``dl_vqa_tpu/models/vit.py::_attention``, for heads that are no
    multiple of 64, where it has no kernel), step for step: the logits in
    the compute dtype (an f32 product of the operands rounded once, then
    divided by ``sqrt(D)`` rounded to the compute dtype, as JAX's weakly
    typed scalar is); ``exp(logits - max)`` in f32, rounded back; an f32
    denominator; ``weights = e / cast(denom)`` in the compute dtype; the PV
    product with f32 accumulation, rounded to the compute dtype. Its
    gradient is autograd's."""
    _check_qkv(qkv, num_heads)
    dtype = qkv.dtype
    batch, seq, three_dim = qkv.shape
    head = three_dim // (3 * num_heads)
    q, k, v = (t.reshape(batch, seq, num_heads, head).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)).to(dtype)
    logits = logits / torch.tensor(head ** 0.5, dtype=dtype)
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    e = torch.exp(shifted.float()).to(dtype)
    denom = e.float().sum(dim=-1, keepdim=True)
    weights = e / denom.to(dtype)
    out = torch.matmul(weights.float(), v.float())
    return _merge(out).to(dtype)


def vit_attention(qkv: torch.Tensor, num_heads: int,
                  plain: bool = False) -> torch.Tensor:
    """Differentiable attention core. Dispatch: a CPU tensor, or
    ``plain=True``, runs the plain versions; a CUDA tensor runs kernels 4
    and 5, which raise where they cannot launch."""
    return VitAttention.apply(qkv, num_heads, plain)
