"""Train and eval steps.

Port of ``dl_vqa_tpu/train/steps.py``: forward, soft cross-entropy,
backward through the port's kernels and one Adam update, with the VQA
metric computed on the device; nothing in a step waits for the device.

LR schedule as there: ``lr * 0.5 ** (updates_done / 50000)``, set before
every update; Adam with betas (0.9, 0.999) and eps 1e-8, whose update
``m_hat / (sqrt(v_hat) + eps)`` is optax's.

Images come in the batch (``images``) or from the device image table
(``image_table`` gathered at ``image_rows``, ``tpu.device_image_cache``);
the table is never split into micro-batches. Dropout masks are drawn from
a generator keyed to ``(seed, updates done)`` and, inside an accumulated
step, to the micro-batch's index, as the JAX step folds its key
(``fold_in``): a run resumed from a checkpoint draws the masks the
uninterrupted run draws (not JAX's masks: the generators differ).
``remat=True`` recomputes the forward in the backward
(``torch.utils.checkpoint``; the masks are drawn again from the same key).

With MoE blocks (``image.moe_experts > 0``) the forward also gives the
layer mean of the blocks' balance losses: the train step adds
``image.moe_aux_weight`` times it to the loss it differentiates and
reports it as ``moe_aux``; the eval loss stays the task loss.

One process is one rank of a 'data' mesh of one. Over a mesh of a
process group (``mesh=``, the state wrapped by
:func:`dl_vqa_tpu_torch.parallel.zero.parallelize`) each rank runs the
same step on its rows of the global batch, as the JAX step runs on a
'data'-sharded batch, and reports the global batch's numbers:

* the loss is normalised once, by the real count of the global batch (an
  all-reduce before the forward), not by each rank's own count, and the
  objective is scaled by the world size, since DDP and FSDP2 average the
  ranks' gradients; an accumulated step's micro-batches before the last
  keep their gradients local (``no_sync``);
* with ``accum_steps > 1`` a rank's batch is its share of every global
  micro-batch, in order
  (:func:`~dl_vqa_tpu_torch.parallel.multihost.process_batch_slice` with
  ``accum_steps``): its k-th chunk is its rows of global micro-batch k,
  the contiguous rows the JAX step takes as its micro-batch k;
* each rank draws its rows of the masks one process draws for the whole
  batch, or for global micro-batch k
  (:class:`~dl_vqa_tpu_torch.models.layers.BatchRows`);
* the MoE balance loss takes its first-choice fractions over every rank's
  tokens of the micro-batch, so each micro-batch's is the JAX step's;
* loss, score and balance loss are all-reduced, as is the eval step's
  output, so every rank reports the same global numbers.

In one process every collective is left out.

Over a mesh with 'model' or 'expert' axes (the state cut by
:func:`dl_vqa_tpu_torch.parallel.tensor.shard_state` before it was
wrapped) the ranks of one 'expert' x 'model' group hold the same rows of
the batch: the model's modules sum over their groups themselves, and every
reduction here (the real count, the metrics, the balance loss's
fractions, the objective's scale) is over the 'data' group, by the rank's
'data' coordinate, as above. Before the update the gradients of what an
axis does not split are made its coordinate-0 rank's
(:func:`~dl_vqa_tpu_torch.parallel.tensor.sync_replicated_grads`), so
the ranks' replicated parameters stay one model. ``fused_ops`` on the ViT
with 'model' above 1 raises: kernel 8 fuses the MLP that 'model' splits
(ROADMAP queue 2's kernel work).

Over a mesh with a 'seq' axis the ranks of one 'seq' group hold the same
rows and split the ViT's tokens (:mod:`dl_vqa_tpu_torch.parallel.
sequence`): after the backward the ViT's parameter gradients, each rank's
part, are summed over the group in f32, and the rest, the same on every
rank of the group, are given its coordinate-0 rank's bits
(:func:`~dl_vqa_tpu_torch.parallel.sequence.sync_sequence_grads`); the
reductions here stay over 'data', but for the MoE balance loss's
factors, which are means over every token of the batch and the sequence:
one all-reduce over the 'data' x 'seq' ranks.

Over a mesh with a 'stage' axis the ViT's blocks run over it
(:mod:`dl_vqa_tpu_torch.parallel.pipeline`), each rank holding its stage's
blocks (the model cut by
:func:`~dl_vqa_tpu_torch.parallel.tensor.shard_model`), and both steps
run the schedule (the eval step forward only).
Every stage rank computes the rest of the model, the loss and the
metrics alike; the gradient of what precedes the blocks reaches stage 0
alone, and :func:`~dl_vqa_tpu_torch.parallel.tensor.sync_replicated_grads`
gives every stage rank stage 0's gradients of all that 'stage' does not
split.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.layers import BatchRows
from dl_vqa_tpu_torch.ops.moe import balance_loss
from dl_vqa_tpu_torch.ops.vqa_metrics import (
    soft_cross_entropy_sum,
    vqa_accuracy_by_type,
    vqa_accuracy_sum,
)
from dl_vqa_tpu_torch.parallel.mesh import FUSED_OPS_UNDER_MODEL
from dl_vqa_tpu_torch.parallel.sequence import sync_sequence_grads
from dl_vqa_tpu_torch.parallel.tensor import sync_replicated_grads
from dl_vqa_tpu_torch.parallel.zero import grad_sync
from dl_vqa_tpu_torch.train.state import TrainState

__all__ = ["make_optimizer", "make_train_step", "make_eval_step",
           "lr_schedule", "dropout_generator", "LR_HALFLIFE"]

LR_HALFLIFE = 50_000.0


def lr_schedule(initial_lr: float) -> Callable[[int], float]:
    """The reference's per-iteration halving law: the LR of the update
    that follows ``count`` updates already done."""

    def schedule(count: int) -> float:
        return initial_lr * 0.5 ** (count / LR_HALFLIFE)

    return schedule


def make_optimizer(model: torch.nn.Module, initial_lr: float
                   ) -> torch.optim.Adam:
    """Adam over the trainable parameters only (the constant ``bias_hh``
    of the LSTM is not among them)."""
    trainable = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(trainable, lr=initial_lr, betas=(0.9, 0.999),
                            eps=1e-8)


def dropout_generator(seed: int, step: int, device,
                      micro: Optional[int] = None) -> torch.Generator:
    """The dropout generator of the update that follows ``step`` updates
    (and of micro-batch ``micro`` inside it), on ``device``: seeded from
    ``(seed, step[, micro])`` alone, so any step's masks can be drawn
    again in isolation."""
    # SeedSequence ignores trailing zero words: a micro-batch's word is
    # its index + 1, so no micro-batch shares the whole step's key.
    words = [int(seed), int(step)] + ([] if micro is None
                                      else [int(micro) + 1])
    key = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(key) >> 1)


def _seed_of(rng: Union[int, torch.Generator]) -> int:
    return rng.initial_seed() if isinstance(rng, torch.Generator) else int(rng)


def _to_device(batch: Dict, device: torch.device) -> Dict:
    """Every array of ``batch`` as a tensor on ``device``; what is there
    already (a prefetched batch, the image table, whole or this rank's
    rows of it) is passed on as it is."""
    return {key: value.to(device) if hasattr(value, "to")
            else torch.as_tensor(value).to(device)
            for key, value in batch.items()}


def _check_fused(cfg: ModelConfig, fused_ops: bool, mesh) -> None:
    if (fused_ops and mesh is not None and mesh.size("model") > 1
            and cfg.image.encoder == "vit"):
        raise NotImplementedError(FUSED_OPS_UNDER_MODEL)


def _images(batch: Dict) -> torch.Tensor:
    images = batch.get("images")
    if images is None:
        images = batch["image_table"].index_select(0, batch["image_rows"])
    return images


def _all_reduce(tensor: torch.Tensor, group) -> None:
    """Sum ``tensor`` over the ranks of ``group`` in place; nothing in one
    process (``group`` None)."""
    if group is not None:
        dist.all_reduce(tensor, group=group)


def _forward_sums(
    forward: torch.nn.Module, cfg: ModelConfig, batch: Dict, train: bool,
    generator: Union[None, torch.Generator, BatchRows],
    compute_dtype: torch.dtype, plain_ops: bool, fused_ops: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
           Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """``(loss_sum, score_sum, logits, balance)``: the one forward of both
    steps, through ``forward`` (the model, or its data-parallel wrapper).
    ``loss_sum`` is the task loss summed over the batch's real rows;
    ``balance`` the MoE layers' first-choice fractions and mean router
    probabilities, ``[L, E]`` each (None for a dense model)."""
    sink = [] if cfg.image.moe_experts > 0 else None
    logits = forward(
        _images(batch), batch["questions"], batch["lengths"], train=train,
        generator=generator, compute_dtype=compute_dtype,
        plain_ops=plain_ops, fused_ops=fused_ops, aux_sink=sink)
    mask = batch.get("mask")
    loss_sum = soft_cross_entropy_sum(logits, batch["answer_indices"],
                                      batch["answer_values"], mask)
    score = vqa_accuracy_sum(logits.detach(), batch["answer_indices"],
                             batch["answer_values"], mask)
    balance = (tuple(torch.stack(factor) for factor in zip(*sink))
               if sink else None)
    return loss_sum, score, logits, balance


def _balance_loss(balance: Tuple[torch.Tensor, torch.Tensor], mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(term, value)`` of the layer mean of the MoE balance losses.
    ``value`` is the loss of the global batch, its factors the means over
    the tokens of every rank of the 'data' x 'seq' block (one all-reduce;
    every rank holds as many tokens); ``term`` is what this rank
    differentiates: the global first-choice fractions (no gradient) times
    this rank's share of the mean router probabilities, so that the
    gradient the wrappers average over 'data', summed over 'seq'
    (:func:`~dl_vqa_tpu_torch.parallel.sequence.sync_sequence_grads`), is
    the global loss's. In one process both are the rank's own loss."""
    frac, mean_prob = balance
    group = mesh.data_seq_group() if mesh is not None else None
    if group is None:
        aux = balance_loss(frac, mean_prob).mean()
        return aux, aux.detach()
    seq = mesh.size("seq")
    stats = torch.cat([frac, mean_prob.detach()])
    _all_reduce(stats, group)
    stats = stats / (mesh.shape["data"] * seq)
    frac_all, prob_all = stats.split(frac.shape[0])
    value = balance_loss(frac_all, prob_all).mean()
    term = balance_loss(frac_all, mean_prob / seq if seq > 1
                        else mean_prob).mean()
    return term, value


def make_train_step(
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    accum_steps: int = 1,
    plain_ops: bool = False,
    fused_ops: bool = False,
    remat: bool = False,
    mesh=None,
):
    """Build ``train_step(state, batch, rng) -> (state, metrics)``.

    ``batch`` maps ``questions``, ``lengths``, ``answer_indices``,
    ``answer_values``, optionally ``mask``, and either ``images`` or
    ``image_table`` with ``image_rows``, to arrays or tensors, which the
    step moves to the device the model lies on (``create_train_state`` puts
    it on the GPU unless told otherwise). ``rng`` is the run's dropout seed,
    an int or a ``torch.Generator`` whose ``initial_seed()`` is taken: the
    masks of each update come from :func:`dropout_generator` keyed to it and
    to ``state.step``. The step updates ``state`` in place and returns it
    with ``{"loss", "score"}`` as 0-dim tensors on the device, and with
    MoE blocks also ``"moe_aux"``, the layer mean of their balance losses
    (1.0 at uniform routing).

    ``accum_steps > 1`` splits the batch into that many micro-batches and
    accumulates their gradients before one update: activation memory is
    a micro-batch's, the update sees the whole batch's gradient, equal to
    the unaccumulated step up to the order of sums. The batch size must
    divide evenly; every micro-batch draws its own dropout masks.
    ``remat=True`` recomputes each forward in its backward.
    ``plain_ops=True`` runs the kernels' plain versions (the oracle);
    ``fused_ops=True`` flips the image encoder to its fused ops (see
    :meth:`VqaNet.forward`; the forward-only ones stay off while gradients
    are recorded).

    ``mesh`` over a process group makes this a rank's step (module
    docstring) for a state wrapped over that mesh: ``batch`` holds this
    rank's rows of the global batch (with ``accum_steps > 1``, its share
    of each global micro-batch, in order). Without one the step is the one
    process's: one rank, no collective.
    """
    cfg.check_ported()
    _check_fused(cfg, fused_ops, mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")
    group = mesh.group("data") if mesh is not None else None
    world, rank = ((mesh.shape["data"], mesh.rank) if group is not None
                   else (1, 0))
    aux_weight = cfg.image.moe_aux_weight

    def loss_of(state, batch, seed, micro):
        # Rank r's micro-batch k: its rows of global micro-batch k.
        rows = batch["questions"].shape[0]

        def run():
            generator = BatchRows(
                dropout_generator(seed, state.step, batch["questions"].device,
                                  None if accum_steps == 1 else micro),
                world * rows, rank * rows)
            loss_sum, score, _, balance = _forward_sums(
                state.forward, cfg, batch, True, generator, compute_dtype,
                plain_ops, fused_ops)
            return (loss_sum, score) + (balance or ())

        out = checkpoint(run, use_reentrant=False) if remat else run()
        return out[0], out[1], out[2:] or None

    def train_step(state: TrainState, batch: Dict,
                   rng: Union[int, torch.Generator]):
        seed = _seed_of(rng)
        device = next(state.model.parameters()).device
        batch = _to_device(batch, device)
        # The image table is indexed by rows, not by the batch: it is not
        # split.
        table = batch.pop("image_table", None)
        local = batch["questions"].shape[0]
        if local % accum_steps != 0:
            raise ValueError(
                f"batch size {local} does not split into "
                f"accum_steps={accum_steps} micro-batches")
        micro_size = local // accum_steps
        # The real count of every micro-batch over the ranks, at once: the
        # loss is normalised once, by the global batch's real count, so a
        # padded batch whose real rows fall unevenly over the micro-batches
        # (or the ranks) weighs every real row alike.
        mask = batch.get("mask")
        counts = (mask.view(accum_steps, micro_size).sum(1).float()
                  if mask is not None
                  else torch.full((accum_steps,), float(micro_size),
                                  device=device))
        _all_reduce(counts, group)
        denom = counts.sum().clamp(min=1.0)
        state.optimizer.zero_grad(set_to_none=True)
        totals = torch.zeros(3, device=device)
        for idx in range(accum_steps):
            rows = slice(idx * micro_size, (idx + 1) * micro_size)
            micro = {key: value[rows] for key, value in batch.items()}
            if table is not None:
                micro["image_table"] = table
            with grad_sync(state.forward, idx == accum_steps - 1):
                loss_sum, score, balance = loss_of(state, micro, seed, idx)
                loss = loss_sum / denom
                # DDP and FSDP2 average the ranks' gradients.
                objective = loss * world
                aux = torch.zeros((), device=device)
                # The balance loss of micro-batch idx, weighted by its
                # share of the real rows as the JAX accumulation weights
                # it (1 without accumulation); each rank reports 1 / world
                # of it.
                share = (counts[idx].clamp(min=1.0) / denom
                         if accum_steps > 1 else 1.0)
                if balance is not None:
                    term, aux = _balance_loss(balance, mesh)
                    objective = objective + aux_weight * term * share
                objective.backward()  # .grad accumulates
            loss = loss.detach()
            totals += torch.stack([loss + aux_weight * aux * share / world,
                                   score, aux * share / world])
        _all_reduce(totals, group)
        if mesh is not None:
            sync_sequence_grads(state.model, mesh)
            sync_replicated_grads(state.model, mesh)

        lr = lr_schedule(state.initial_lr)(state.step)
        for param_group in state.optimizer.param_groups:
            param_group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": totals[0], "score": totals[1]}
        if cfg.image.moe_experts > 0:
            metrics["moe_aux"] = totals[2]
        return state, metrics

    return train_step


def make_eval_step(
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    with_breakdown: bool = False,
    plain_ops: bool = False,
    fused_ops: bool = False,
    mesh=None,
):
    """Build ``eval_step(model, batch) -> (loss, score_sum)``, 0-dim
    tensors on the model's device, to which the step moves the batch
    (images in it, or the image table and rows, as the train step).
    ``with_breakdown=True`` also returns the per-answer-type (yes/no,
    number, other) score sums and counts, each ``[3]``, from
    ``batch["answer_types"]``. With ``mesh`` over a process group
    ``batch`` is this rank's rows and every output is the global batch's
    (one all-reduce a batch); ``model`` may be FSDP2-sharded."""
    cfg.check_ported()
    _check_fused(cfg, fused_ops, mesh)
    group = mesh.group("data") if mesh is not None else None

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch: Dict):
        batch = _to_device(batch, next(model.parameters()).device)
        mask = batch.get("mask")
        loss_sum, score, logits, _ = _forward_sums(
            model, cfg, batch, False, None, compute_dtype, plain_ops,
            fused_ops)
        count = (mask.sum().float() if mask is not None
                 else torch.full((), float(logits.shape[0]),
                                 device=logits.device))
        parts = [loss_sum.reshape(1), score.reshape(1), count.reshape(1)]
        if with_breakdown:
            parts += vqa_accuracy_by_type(
                logits, batch["answer_indices"], batch["answer_values"],
                batch["answer_types"], mask)
        totals = torch.cat(parts)
        _all_reduce(totals, group)
        loss = totals[0] / totals[2].clamp(min=1.0)
        if not with_breakdown:
            return loss, totals[1]
        return loss, totals[1], totals[3:6], totals[6:9]

    return eval_step
