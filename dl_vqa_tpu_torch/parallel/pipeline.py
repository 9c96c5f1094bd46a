"""GPipe pipeline parallelism over the 'stage' mesh axis
(``tpu.mesh.stage``): the port's counterpart of
``dl_vqa_tpu/parallel/pipeline.py``.

The ViT's block stack splits into ``S`` contiguous stages of ``L / S``
blocks, one a rank of the 'stage' group (each rank's model holds only its
own blocks, :func:`~dl_vqa_tpu_torch.parallel.tensor.shard_model`). The
batch splits into ``M`` microbatches, which stream through the stages:

* forward, stage ``s`` takes microbatch ``m`` from stage ``s - 1`` (stage
  0 from its input), runs its blocks on it and sends the result to stage
  ``s + 1``; the last stage's outputs are then broadcast to every stage
  rank, so what follows the blocks (the head, the text encoder, the
  classifier, replicated over 'stage' as in JAX) runs on every rank;
* backward, the reverse schedule: the last stage takes the gradient of
  its own output (every stage rank computes the same one: taking each
  would count it ``S`` times), and each stage sends each microbatch's
  input gradient to the stage before it. The blocks' parameter gradients
  are summed over the microbatches and returned once, so a wrapper that
  watches them (DDP, FSDP2) sees each parameter's gradient arrive once.

JAX runs the schedule as one SPMD program of ``M + S - 1`` ticks in which
every stage computes, the fill and drain ticks on clamped inputs whose
results are thrown away; the port's ranks are separate programs, so a
stage computes only the ``M`` microbatches it has. Every send and receive
is tagged by (microbatch, direction), and each rank posts them in one
fixed order, so ranks whose autograd engines order other work
differently cannot cross. Over gloo a CUDA tensor travels through host
memory (gloo's point-to-point takes host buffers).

Dropout in the blocks: each site (21 + 2i, 22 + 2i) draws the whole
batch's mask from the step's generator, as one process draws it, in the
same order and for every block (so the generator leaves the blocks where
one process leaves it), and a microbatch keeps its rows
(:func:`~dl_vqa_tpu_torch.models.layers.draw_masks`). The pipelined step
thus equals one process's step with dropout on. This departs from the
JAX package's stream, which folds the microbatch's index into the site
keys; the port's masks never match JAX's generator in any case.

What the JAX package refuses under 'stage' raises its words
(:func:`check_pipeline`, :func:`microbatch_rows`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["PipelineContext", "pipeline_apply", "stage_layers",
           "check_pipeline", "microbatch_rows", "NO_LAYER_STRUCTURE"]

NO_LAYER_STRUCTURE = (
    "tpu.mesh.stage > 1 (pipeline parallelism) requires "
    "train.image.encoder=vit — the cnn stack has no repeated "
    "layer structure to stage")
INT8_WITH_STAGE = (
    "image.store_dtype='int8' (ViT W8A8) does not compose with "
    "tpu.mesh.stage > 1: the GPipe executor's homogeneous layer "
    "stack cannot carry per-layer static scales")
MOE_WITH_STAGE = (
    "image.moe_experts > 0 does not compose with "
    "tpu.mesh.stage > 1 yet: the GPipe executor's shard_map "
    "cannot carry the expert axis or the aux-loss side "
    "channel. Use a dp x expert x model mesh instead.")


@dataclasses.dataclass(frozen=True)
class PipelineContext:
    """The mesh carrying the 'stage' axis and the microbatch count, as the
    JAX package's ``PipelineContext``. The ViT of a model cut over 'stage'
    holds it (:func:`~dl_vqa_tpu_torch.parallel.tensor.shard_model`), and
    its blocks then run through the schedule."""

    mesh: object
    num_microbatches: int


def stage_layers(num_layers: int, stages: int, index: int) -> slice:
    """The layers of stage ``index`` of ``stages``: ``L / S`` contiguous
    ones; raises the JAX words where ``S`` does not divide ``L``."""
    if num_layers % stages:
        raise ValueError(
            f"{num_layers} layers do not split over {stages} stages")
    per = num_layers // stages
    return slice(index * per, (index + 1) * per)


def check_pipeline(cfg, stages: int) -> None:
    """Raise what the JAX model raises for a model of ``cfg`` under a
    'stage' axis of ``stages`` ranks: the CNN (``ValueError``), the int8
    ViT and a ViT-MoE (``NotImplementedError``), and a layer count the
    axis does not divide."""
    if stages < 2:
        return
    image = cfg.image
    if image.encoder != "vit":
        raise ValueError(NO_LAYER_STRUCTURE)
    if image.store_dtype == "int8":
        raise NotImplementedError(INT8_WITH_STAGE)
    if image.moe_experts > 0:
        raise NotImplementedError(MOE_WITH_STAGE)
    stage_layers(image.num_layers, stages, 0)


def microbatch_rows(rows: int, ctx: PipelineContext) -> int:
    """The rows of each of ``ctx.num_microbatches`` microbatches of a
    rank's ``rows`` (its share of the global batch over 'data'); raises
    the JAX words for a count below one, a global batch the count does
    not divide, and a global microbatch the 'data' axis does not
    divide."""
    micro = ctx.num_microbatches
    if micro < 1:
        raise ValueError("need at least one microbatch")
    data = ctx.mesh.size("data")
    batch = rows * data
    if batch % micro:
        raise ValueError(
            f"batch {batch} does not split into {micro} pipeline "
            "microbatches")
    if (batch // micro) % data:
        raise ValueError(
            f"microbatch size {batch // micro} does not shard over the "
            f"{data}-way 'data' axis")
    return rows // micro


@dataclasses.dataclass(frozen=True)
class _Stage:
    """This rank's place in its 'stage' group: the group, its global
    ranks in stage order and this rank's stage."""

    group: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == len(self.ranks) - 1


def _stage_of(mesh) -> Optional[_Stage]:
    if mesh is None or not mesh.distributed or mesh.size("stage") < 2:
        return None
    group = mesh.group("stage")
    ranks = tuple(dist.get_global_rank(group, i)
                  for i in range(mesh.size("stage")))
    return _Stage(group, ranks, mesh.coord("stage"))


def _tag(micro: int, backward: bool) -> int:
    return 2 * micro + int(backward)


def _host_route(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _send(t: torch.Tensor, dst: int, tag: int, group) -> None:
    t = t.detach().contiguous()
    dist.send(t.cpu() if _host_route(t, group) else t, dst, group=group,
              tag=tag)


def _recv(like: torch.Tensor, src: int, tag: int, group) -> torch.Tensor:
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    if _host_route(out, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.recv(host, src, group=group, tag=tag)
        return out.copy_(host)
    dist.recv(out, src, group=group, tag=tag)
    return out


def _tensors(layers) -> List[torch.Tensor]:
    """The tensors that need a gradient inside ``layers`` (modules and
    tensors, in sequences), each once, in order."""
    out, seen = [], set()

    def walk(node):
        if isinstance(node, (list, tuple)):
            for value in node:
                walk(value)
            return
        found = (node.parameters() if isinstance(node, nn.Module)
                 else (node,) if isinstance(node, torch.Tensor) else ())
        for t in found:
            if t.requires_grad and id(t) not in seen:
                seen.add(id(t))
                out.append(t)

    walk(layers)
    return out


def _broadcast_last(result: torch.Tensor, stage: _Stage) -> torch.Tensor:
    dist.broadcast(result, src=stage.ranks[-1], group=stage.group)
    return result


def _forward_schedule(run: Callable, stage: _Stage, x: torch.Tensor,
                      keep: Optional[list]) -> torch.Tensor:
    """This stage's part of the forward schedule over ``x [M, mb, ...]``;
    with ``keep`` (a list) each microbatch's ``(input, output)`` is kept
    there with its graph. Returns the last stage's outputs on every
    rank."""
    outputs = []
    for m in range(x.shape[0]):
        if stage.first:
            inp = x[m]
            if keep is not None:
                inp = inp.detach().requires_grad_(x.requires_grad)
        else:
            inp = _recv(x[m], stage.ranks[stage.index - 1],
                        _tag(m, False), stage.group)
            if keep is not None:
                inp.requires_grad_(True)
        out = run(inp, m)
        if out.shape != inp.shape or out.dtype != inp.dtype:
            raise ValueError(
                f"a pipelined layer maps {tuple(inp.shape)} {inp.dtype} to "
                f"{tuple(out.shape)} {out.dtype}; the stages pass one "
                "shape and dtype")
        if stage.last:
            outputs.append(out.detach())
        else:
            _send(out, stage.ranks[stage.index + 1], _tag(m, False),
                  stage.group)
        if keep is not None:
            keep.append((inp, out))
    result = torch.stack(outputs) if stage.last else torch.empty_like(x)
    return _broadcast_last(result, stage)


class _Pipeline(torch.autograd.Function):
    """The schedule as one node of the autograd graph: inputs ``x`` and
    this stage's parameters, output the last stage's ``[M, mb, ...]``."""

    @staticmethod
    def forward(ctx, run, stage, x, *params):
        ctx.stage, ctx.params = stage, params
        ctx.x_grad = x.requires_grad
        ctx.kept = []
        with torch.enable_grad():
            return _forward_schedule(run, stage, x, ctx.kept)

    @staticmethod
    def backward(ctx, grad):
        stage, params, kept = ctx.stage, ctx.params, ctx.kept
        ctx.kept = None
        grad_x = None
        sums = [None] * len(params)
        for m in reversed(range(len(kept))):
            inp, out = kept[m]
            kept[m] = None
            if stage.last:
                g = grad[m] if grad is not None else torch.zeros_like(out)
            else:
                g = _recv(out, stage.ranks[stage.index + 1], _tag(m, True),
                          stage.group)
            wants = ([inp] if inp.requires_grad else []) + list(params)
            got = torch.autograd.grad(out, wants, g, allow_unused=True)
            if inp.requires_grad:
                g_in, got = got[0], got[1:]
                if g_in is None:
                    g_in = torch.zeros_like(inp)
                if not stage.first:
                    _send(g_in, stage.ranks[stage.index - 1], _tag(m, True),
                          stage.group)
                elif ctx.x_grad:
                    if grad_x is None:
                        grad_x = g_in.new_zeros((len(kept),) + g_in.shape)
                    grad_x[m] = g_in
            for i, g_p in enumerate(got):
                if g_p is not None:
                    sums[i] = g_p if sums[i] is None else sums[i] + g_p
        if ctx.x_grad and grad_x is None and grad is not None:
            # Only stage 0 feeds the input: elsewhere its gradient is 0.
            grad_x = torch.zeros_like(grad)
        return (None, None, grad_x, *sums)


def pipeline_apply(layer_fn: Callable, layers: Sequence,
                   x_microbatched: torch.Tensor, mesh) -> torch.Tensor:
    """Run this stage's ``layers`` (``L / S`` of them, :func:`stage_layers`)
    as its part of an ``S``-stage pipeline over the microbatches
    ``x_microbatched [M, mb, ...]`` (this rank's rows); returns the
    outputs ``[M, mb, ...]`` of the whole stack on every rank of the
    'stage' group: numerically the layers applied in order to every
    microbatch. ``layer_fn(layer, x, m)`` applies one layer to microbatch
    ``m``. ``layers``: modules and tensors, or sequences of them.
    Differentiable in ``x_microbatched`` and in every tensor of ``layers``
    that needs a gradient (a module's parameters among them). Where
    ``mesh`` has one stage, or no group, the layers run in order."""
    layers = list(layers)
    if x_microbatched.shape[0] < 1:
        raise ValueError("need at least one microbatch")

    def run(x, m):
        for layer in layers:
            x = layer_fn(layer, x, m)
        return x

    stage = _stage_of(mesh)
    if stage is None:
        return torch.stack([run(x_microbatched[m], m)
                            for m in range(x_microbatched.shape[0])])
    params = _tensors(layers)
    if torch.is_grad_enabled() and (x_microbatched.requires_grad or params):
        return _Pipeline.apply(run, stage, x_microbatched, *params)
    return _forward_schedule(run, stage, x_microbatched, None)
