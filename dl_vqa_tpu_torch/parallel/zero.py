"""Data parallelism and ZeRO stages 1 and 3 over the mesh's 'data' axis.

The JAX package annotates the train state's placement and lets the SPMD
partitioner derive the collectives (``dl_vqa_tpu/parallel/mesh.py::
zero_spec``, ``state_shardings``). The port wraps the model instead
(:func:`parallelize`):

* stage 0: ``DistributedDataParallel``; its bucketed all-reduce of the
  gradients overlaps the backward, and every rank keeps the whole Adam
  state;
* stage 1: DDP and :class:`ShardedAdam`: each rank keeps the Adam moments
  of its slice of the flattened trainable parameters (``ceil(n / data)``
  elements), updates that slice with ``torch.optim.Adam`` itself, and the
  slices are all-gathered into the parameters;
* stage 3: FSDP2's ``fully_shard`` on the model: each rank keeps the dim-0
  shard of every parameter and of its Adam moments between steps; the
  parameters are all-gathered for the forward and the backward and the
  gradients reduce-scattered.

DDP and FSDP2 average the ranks' gradients; the data-parallel train step
(:mod:`dl_vqa_tpu_torch.train.steps`) scales its objective by the world
size so that what they average is the global batch's gradient. The
constant LSTM ``bias_hh`` (``requires_grad=False``) stays outside Adam in
every stage; the caller folds it into ``bias_ih`` before wrapping
(``train.loop.train``).

Over a mesh whose 'model', 'expert' or 'stage' axis splits the
parameters (:func:`dl_vqa_tpu_torch.parallel.tensor.shard_state`, called
first) every wrapper runs over the 'data' group and sub-mesh alone, on
this rank's shards: the ranks of a 'data' group hold the same shards (a
stage rank its blocks and the rest of the model).

A checkpoint holds the whole state whatever the stage and the mesh:
:func:`full_state` gathers the parameters and moments on every rank (a
collective: over 'data', then over 'model', 'expert' and 'stage'), and a
restore
loads the whole state into the unwrapped, uncut model before
:func:`~dl_vqa_tpu_torch.parallel.tensor.shard_state` and
:func:`parallelize` split it, so a state moves between mesh shapes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from dl_vqa_tpu_torch.parallel.tensor import gather_named
from dl_vqa_tpu_torch.utils.checkpoint import _trainable

__all__ = ["parallelize", "ShardedAdam", "full_state", "grad_sync",
           "moments_held"]


class ShardedAdam:
    """ZeRO-1 Adam: this rank's slice ``[lo, hi)`` of the trainable
    parameters, flattened in order, is one f32 tensor that an inner
    ``torch.optim.Adam`` updates (the moments exist for the slice only);
    :meth:`step` all-gathers the updated slices into the parameters.
    ``param_groups[0]["lr"]`` is read at each step, as the train step sets
    it on a torch optimizer."""

    def __init__(self, params, lr: float, group, world: int, rank: int,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        self.param_groups = [{"params": self.params, "lr": lr}]
        self.group, self.world = group, world
        self.total = sum(p.numel() for p in self.params)
        self.per = -(-self.total // world)
        self.lo = min(rank * self.per, self.total)
        self.hi = min(self.lo + self.per, self.total)
        device = self.params[0].device
        self.flat = torch.zeros(self.hi - self.lo, dtype=torch.float32,
                                device=device, requires_grad=True)
        self.inner = torch.optim.Adam([self.flat], lr=lr, betas=betas,
                                      eps=eps)

    def _pieces(self, tensors) -> torch.Tensor:
        """This rank's slice of ``tensors`` flattened in order."""
        pieces, at = [], 0
        for t in tensors:
            n = t.numel()
            lo, hi = max(self.lo, at), min(self.hi, at + n)
            if lo < hi:
                pieces.append(t.reshape(-1)[lo - at:hi - at])
            at += n
        if not pieces:
            return self.flat.new_zeros(0)
        return torch.cat(pieces)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.flat.copy_(self._pieces([p.detach() for p in self.params]))
        self.flat.grad = self._pieces([p.grad for p in self.params])
        self.inner.param_groups[0]["lr"] = self.param_groups[0]["lr"]
        self.inner.step()
        full = self._gather(self.flat.detach())
        at = 0
        for p in self.params:
            n = p.numel()
            p.copy_(full[at:at + n].view_as(p))
            at += n

    def _gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole flat vector from every rank's slice."""
        padded = local.new_zeros(self.per)
        padded[:local.numel()] = local
        parts = [torch.empty_like(padded) for _ in range(self.world)]
        dist.all_gather(parts, padded, group=self.group)
        return torch.cat(parts)[:self.total]

    def load_moments(self, moments: Dict[int, Dict[str, torch.Tensor]]
                     ) -> None:
        """Take this rank's slice of full per-parameter moments
        (``{index: {"exp_avg", "exp_avg_sq", "step"}}`` of a torch Adam)."""
        if not moments:
            return
        slot = {"step": next(iter(moments.values()))["step"].clone()}
        for key in ("exp_avg", "exp_avg_sq"):
            slot[key] = self._pieces(
                [moments[i][key].to(p.device) for i, p in
                 enumerate(self.params)]).clone()
        self.inner.state[self.flat] = slot

    def full_moments(self) -> Tuple[List[Dict[str, torch.Tensor]], int]:
        """Every parameter's whole moments, gathered from all ranks (a
        collective), and the update count."""
        slot = self.inner.state.get(self.flat, {})
        full = {key: self._gather(slot[key] if key in slot
                                  else torch.zeros_like(self.flat.detach()))
                for key in ("exp_avg", "exp_avg_sq")}
        out, at = [], 0
        for p in self.params:
            n = p.numel()
            out.append({key: value[at:at + n].view_as(p)
                        for key, value in full.items()})
            at += n
        return out, int(slot["step"]) if "step" in slot else 0


def _shard_like(full: torch.Tensor, param) -> torch.Tensor:
    """``full`` split as the FSDP2 parameter ``param`` is (its dim-0 shard
    on this rank), as a DTensor."""
    from torch.distributed.tensor import DTensor

    mesh = param.device_mesh
    world, rank = mesh.size(), mesh.get_local_rank()
    chunks = torch.chunk(full, world, dim=0)
    local = (chunks[rank] if rank < len(chunks)
             else full.new_zeros((0,) + tuple(full.shape[1:])))
    expected = tuple(param.to_local().shape)
    if tuple(local.shape) != expected:
        raise ValueError(f"moment shard {tuple(local.shape)} does not match "
                         f"the parameter's shard {expected}")
    return DTensor.from_local(local.contiguous().to(param.to_local().device),
                              mesh, param.placements, run_check=False,
                              shape=param.shape, stride=param.stride())


def parallelize(state, mesh, zero_stage: int = 0):
    """Wrap ``state`` (a :class:`~dl_vqa_tpu_torch.train.state.TrainState`
    whose model and full Adam state are the same on every rank) for the
    mesh's 'data' axis at ZeRO stage ``zero_stage`` (0, 1 or 3); returns
    it with ``forward`` (what the train step calls), ``mesh`` and
    ``zero_stage`` set. A mesh over no process group leaves it as it is;
    one over a group of one rank wraps it all the same."""
    if zero_stage not in (0, 1, 3):
        raise ValueError(f"zero_stage must be 0, 1 or 3, got {zero_stage!r}")
    if not mesh.distributed:
        return state
    from dl_vqa_tpu_torch.train.steps import make_optimizer

    model = state.model
    device = next(model.parameters()).device
    names = list(_trainable(model))
    old = state.optimizer
    moments = {i: old.state[p] for i, p in enumerate(_trainable(model)
                                                     .values())
               if p in old.state}
    if zero_stage == 3:
        from torch.distributed.fsdp import fully_shard

        fully_shard(model, mesh=mesh.device_mesh["data"])
        state.optimizer = make_optimizer(model, state.initial_lr)
        params = _trainable(model)
        for i, name in enumerate(names):
            if i in moments:
                p = params[name]
                slot = moments[i]
                state.optimizer.state[p] = {
                    "step": slot["step"].clone(),
                    "exp_avg": _shard_like(slot["exp_avg"], p),
                    "exp_avg_sq": _shard_like(slot["exp_avg_sq"], p)}
        state.forward = model
    else:
        from torch.nn.parallel import DistributedDataParallel

        state.forward = DistributedDataParallel(
            model, process_group=mesh.group("data"),
            device_ids=[device.index] if device.type == "cuda" else None)
        if zero_stage == 1:
            state.optimizer = ShardedAdam(
                _trainable(model).values(), state.initial_lr,
                mesh.group("data"), mesh.shape["data"], mesh.rank)
            state.optimizer.load_moments(moments)
    state.mesh, state.zero_stage = mesh, zero_stage
    return state


@contextlib.contextmanager
def grad_sync(forward, enabled: bool):
    """Within the block, the backward of ``forward`` (DDP or FSDP2)
    reduces the gradients over the ranks only if ``enabled``: the
    micro-batches of an accumulated step before the last one keep theirs
    local. An unwrapped model reduces nothing either way."""
    if not enabled and hasattr(forward, "no_sync"):  # DDP
        with forward.no_sync():
            yield
    elif not enabled and hasattr(forward, "set_requires_gradient_sync"):
        forward.set_requires_gradient_sync(False)  # FSDP2
        try:
            yield
        finally:
            forward.set_requires_gradient_sync(True)
    else:
        yield


def _full(tensor: torch.Tensor) -> torch.Tensor:
    """The whole of an FSDP2 tensor (its dim-0 shards, ``torch.chunk``'s
    split, gathered with ``all_gather``); any other tensor as it is.
    ``DTensor.full_tensor`` would do it, but its functional all-gather
    ended both ranks with signal 11 over gloo on CUDA tensors (torch
    2.11), where ``all_gather`` runs."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(tensor, DTensor):
        return tensor
    if tuple(tensor.placements) != (Shard(0),):
        return tensor.full_tensor()
    mesh = tensor.device_mesh
    world, local = mesh.size(), tensor.to_local()
    rows = tensor.shape[0]
    per = -(-rows // world)
    padded = local.new_zeros((per,) + tuple(tensor.shape[1:]))
    padded[:local.shape[0]] = local
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=mesh.get_group())
    return torch.cat(parts)[:rows]


def full_state(state) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, Dict[str, torch.Tensor]], int]:
    """``(named parameters and buffers, {"exp_avg": named, "exp_avg_sq":
    named}, update count)``, whole, whatever the stage and the mesh: under
    ZeRO, 'model' or 'expert' the pieces are gathered from every rank, so
    every rank calls this. Moments of a parameter not yet updated are
    zeros."""
    named, moments, count = _data_state(state)
    if getattr(state.model, "tp_specs", None) is not None:
        named = gather_named(named, state.model, state.mesh)
        moments = {key: gather_named(value, state.model, state.mesh)
                   for key, value in moments.items()}
    return named, moments, count


def _data_state(state):
    """:func:`full_state` gathered over 'data' alone: this rank's shards
    of 'model' and 'expert'."""
    model = state.model
    named = {name: _full(value.detach())
             for name, value in model.state_dict().items()}
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    trainable = _trainable(model)
    if isinstance(state.optimizer, ShardedAdam):
        slots, count = state.optimizer.full_moments()
        for name, slot in zip(trainable, slots):
            for key in moments:
                moments[key][name] = slot[key]
        return named, moments, count
    counts = set()
    for name, p in trainable.items():
        slot = state.optimizer.state.get(p, {})
        for key in moments:
            value = slot.get(key)
            moments[key][name] = (_full(value) if value is not None
                                  else torch.zeros(p.shape, dtype=p.dtype,
                                                   device=p.device))
        counts.add(int(slot["step"]) if "step" in slot else 0)
    if len(counts) > 1:
        raise ValueError(f"Adam step counts differ across parameters: "
                         f"{sorted(counts)}; one count per state is saved")
    return named, moments, counts.pop() if counts else 0


def moments_held(state) -> Tuple[int, int]:
    """``(elements of the Adam moments this rank holds, elements of the
    trainable parameters it holds)``: about ``1 / data`` of the whole at
    ZeRO stage 1 (the moments) and 3 (both)."""
    from torch.distributed.tensor import DTensor

    def local(t):
        return (t.to_local() if isinstance(t, DTensor) else t).numel()

    params = sum(local(p) for p in _trainable(state.model).values())
    if isinstance(state.optimizer, ShardedAdam):
        slot = state.optimizer.inner.state.get(state.optimizer.flat, {})
        held = sum(slot[k].numel() for k in ("exp_avg", "exp_avg_sq")
                   if k in slot)
        return held, params
    held = 0
    for slot in state.optimizer.state.values():
        held += sum(local(slot[k]) for k in ("exp_avg", "exp_avg_sq")
                    if k in slot)
    return held, params
