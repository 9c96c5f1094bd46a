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

import dataclasses
import functools
from typing import Tuple

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["vit_attention_reference", "vit_attention_cuda",
           "vit_attention_backward_reference", "vit_attention_backward_cuda",
           "VitAttention", "vit_attention", "vit_attention_weights_normalised",
           "kernel_head", "AttentionPlan", "attention_plan", "wgmma_plan",
           "backward_grids"]

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
    bf16 forward spreads a head's query slabs over several blocks, and the
    wgmma design takes smaller blocks."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# The wgmma design (csrc/vit_attention_wgmma.cuh): a ring tile is 64 rows of
# every 64-wide head slice (128 bytes a row), a block 64, 128 or 192 rows of
# its own (a consumer warpgroup each), 1024 bytes to align the tiles and 128
# for the mbarriers; kernel 5's second grid adds a [3][64] f32 statistics
# tile, padded to 1024 bytes, to each stage.
WGMMA_HEADS = (64, 128)
RING_ROWS = 64
RING_STAGES = 4
RING_MIN_STAGES = 2  # csrc kMinStages: one computed on, one loading
# A block of n consumer warpgroups (64 n rows) takes about this much of the
# time of a block of one: n of them share the SM, each hiding the others'
# latency (`tools/compare_vit_attention.py --rows`, PERF.md).
BLOCK_COST = {1: 1.0, 2: 1.25, 3: 1.5}
SMEM_PER_BLOCK = 232448  # an sm_90 block's dynamic shared memory
_SLICE_BYTES = RING_ROWS * 128
_STAT_BYTES = 1024
_ALIGN_BYTES, _BARRIER_BYTES = 1024, 128

# Design names -> the C entries' design code: the wgmma kernels take their
# tiling from the plan; every other design is the C entries' own dispatch,
# which the plan only names.
DESIGNS = {"rows_mma": 0, "key_tiles_mma": 0, "rows_fma": 0,
           "key_tiles_fma": 0, "wgmma": 1}


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """How kernels 4 and 5 take one shape (:func:`attention_plan`).
    ``design``: ``rows_mma`` (bf16 up to :data:`ROW_SEQ` tokens, a score
    row in a warp's registers, mma.sync), ``key_tiles_mma`` (bf16 past it,
    heads of 192 and more: mma.sync over a cp.async ring), ``wgmma`` (bf16
    past it, heads of 64 and 128), ``rows_fma`` and ``key_tiles_fma``
    (f32). For ``wgmma``: ``rows`` a block (queries; keys in kernel 5's
    second grid), ``key_tile`` rows a ring stage, ``stages``, the dynamic
    shared bytes of kernel 4 (``shared``) and of kernel 5's grids
    (``shared_dq``, ``shared_dkdv``); zero for the other designs, whose C
    code tiles as it always has. ``grids``: kernel 5's grids a call.
    ``stats_len``: a row of kernel 5's f32 statistics ``[B, H, 3,
    stats_len]`` (0 where it has none)."""
    design: str
    grids: int
    stats_len: int
    rows: int = 0
    key_tile: int = 0
    stages: int = 0
    shared: int = 0
    shared_dq: int = 0
    shared_dkdv: int = 0

    def c_args(self) -> Tuple[int, ...]:
        """The eight ints both C entries take after the dtype code."""
        return (DESIGNS[self.design], self.rows, self.key_tile, self.stages,
                self.shared, self.shared_dq, self.shared_dkdv,
                self.stats_len)


def ring_shared(fixed: int, stage: int, stages: int) -> int:
    """Shared bytes of a wgmma block (``vit_attention_wgmma.cuh``
    ``ring_shared``): the alignment, its own rows, the ring, the
    mbarriers."""
    return _ALIGN_BYTES + fixed + stages * stage + _BARRIER_BYTES


@functools.lru_cache(maxsize=None)
def attention_plan(dtype: torch.dtype, head: int, seq: int, batch: int,
                   sms: int) -> AttentionPlan:
    """Kernels 4 and 5 on ``batch`` (image, head) pairs (B times H) of
    ``seq`` tokens and heads of ``head`` in ``dtype``, on a card of ``sms``
    SMs. bf16 heads of 64 and 128 past :data:`ROW_SEQ` tokens take the
    wgmma design: 64-row ring tiles, RING_STAGES stages (fewer where they
    do not fit; RING_MIN_STAGES always do at these heads), and blocks of
    one, two or three consumer warpgroups (64, 128 or 192 rows), whichever
    takes the fewest waves of blocks over the SMs, a wave of blocks of n
    consumers costing BLOCK_COST[n] (ties to the larger block): more
    consumers a block hide more of each one's latency, fewer make more
    blocks for a small batch. A row's arithmetic does not depend on the
    block that takes it, so neither do its bits on ``batch`` or ``sms``."""
    two = 2 if dtype == torch.float32 or head != HEAD_SLICE else 1
    if seq <= ROW_SEQ:
        design = "rows_mma" if dtype == torch.bfloat16 else "rows_fma"
        return AttentionPlan(design, two, seq if two == 2 else 0)
    if dtype != torch.bfloat16:
        return AttentionPlan("key_tiles_fma", 2, seq)
    if head not in WGMMA_HEADS:
        return AttentionPlan("key_tiles_mma", 2, seq)
    rows = RING_ROWS * min(
        (3, 2, 1), key=lambda n: -(-batch * -(-seq // (n * RING_ROWS)) // sms)
        * BLOCK_COST[n])
    return wgmma_plan(head, seq, rows)


def wgmma_plan(head: int, seq: int, rows: int) -> AttentionPlan:
    """The wgmma design at heads of ``head`` (64 or 128), ``seq`` tokens
    and blocks of ``rows`` rows (64, 128 or 192): the ring's stages and the
    three kernels' shared bytes."""
    slices = head // HEAD_SLICE
    slice_rows = slices * rows * 128  # a block's rows of one tensor
    # kernel 4: q; k | v a stage. kernel 5: q, g (k, v); k | v (q | g |
    # statistics) a stage.
    layouts = ((slice_rows, 2 * slices * _SLICE_BYTES),
               (2 * slice_rows, 2 * slices * _SLICE_BYTES),
               (2 * slice_rows, 2 * slices * _SLICE_BYTES + _STAT_BYTES))
    stages = min(RING_STAGES, *(
        (SMEM_PER_BLOCK - ring_shared(fixed, 0, 0)) // stage
        for fixed, stage in layouts))
    shared = [ring_shared(fixed, stage, stages) for fixed, stage in layouts]
    return AttentionPlan("wgmma", 2, -(-seq // RING_ROWS) * RING_ROWS,
                         rows, RING_ROWS, stages, *shared)


def _plan(qkv: torch.Tensor, num_heads: int, head: int) -> AttentionPlan:
    batch, seq, _ = qkv.shape
    return attention_plan(qkv.dtype, head, seq, batch * num_heads,
                          _sm_count(qkv.device.index))


def vit_attention_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel 4 on ``qkv``'s CUDA device; raises on any input it does not
    take."""
    head = _check_cuda(qkv, num_heads, "vit_attention_cuda")
    batch, seq, three_dim = qkv.shape
    plan = _plan(qkv, num_heads, head)
    lib = _native.library()
    out = torch.empty(batch, seq, three_dim // 3, dtype=qkv.dtype,
                      device=qkv.device)
    code = lib.vqa_vit_attention(
        qkv.data_ptr(), out.data_ptr(), batch, seq, num_heads, head,
        _scale(head), _sm_count(qkv.device.index), _DTYPES[qkv.dtype],
        *plan.c_args(), _native.stream_ptr(qkv.device))
    _native.check("vit_attention", code)
    if batch and seq:  # the C entry launches nothing for empty input
        vit_attention_cuda.launches += 1
        if plan.design == "wgmma":
            vit_attention_cuda.launches_wgmma += 1
    return out


vit_attention_cuda.launches = 0
vit_attention_cuda.launches_wgmma = 0  # those of the wgmma kernel


def _attention_fake(qkv, num_heads):
    batch, seq, three_dim = qkv.shape
    return qkv.new_empty(batch, seq, three_dim // 3)


_native.define_op("vit_attention", "(Tensor qkv, int num_heads) -> Tensor",
                  vit_attention_reference, vit_attention_cuda,
                  _attention_fake)


def backward_grids(dtype: torch.dtype, head: int, seq: int = 0) -> int:
    """Grids a kernel-5 call launches, as :func:`attention_plan` says: one
    for bf16 heads of 64 up to :data:`ROW_SEQ` tokens, two (dq, then dk and
    dv) for f32, for wider heads and for longer sequences."""
    return attention_plan(dtype, head, seq, 1, 1).grids


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
    plan = _plan(qkv, num_heads, head)
    lib = _native.library()
    dqkv = torch.empty_like(qkv)
    # bf16 heads of 64 up to ROW_SEQ tokens: one grid, the row statistics
    # stay in shared memory. Otherwise per query row m, denom and
    # rowsum(dw w), which the first of two grids writes and the second
    # reads.
    stats = (torch.empty(batch, num_heads, 3, plan.stats_len,
                         dtype=torch.float32, device=qkv.device)
             if plan.grids == 2 else None)
    code = lib.vqa_vit_attention_backward(
        qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
        None if stats is None else stats.data_ptr(), batch, seq, num_heads,
        head, _scale(head), _DTYPES[qkv.dtype], *plan.c_args(),
        _native.stream_ptr(qkv.device))
    _native.check("vit_attention_backward", code)
    if batch and seq:
        vit_attention_backward_cuda.launches += plan.grids
        if plan.design == "wgmma":
            vit_attention_backward_cuda.launches_wgmma += plan.grids
    return dqkv


vit_attention_backward_cuda.launches = 0
vit_attention_backward_cuda.launches_wgmma = 0  # those of the wgmma grids


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
