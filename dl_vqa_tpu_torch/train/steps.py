"""Train and eval steps.

Port of ``dl_vqa_tpu/train/steps.py``: forward, soft cross-entropy,
backward through the port's kernels and one Adam update, with the VQA
metric computed on the device; nothing in a step waits for the device.

LR schedule as there: ``lr * 0.5 ** (updates_done / 50000)``, set before
every update; Adam with betas (0.9, 0.999) and eps 1e-8, whose update
``m_hat / (sqrt(v_hat) + eps)`` is optax's.

Not ported yet: rematerialisation, sharded steps, the pipeline and
sequence contexts, the MoE auxiliary loss and the device image table.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.ops.vqa_metrics import (
    soft_cross_entropy,
    vqa_accuracy_by_type,
    vqa_accuracy_sum,
)
from dl_vqa_tpu_torch.train.state import TrainState

__all__ = ["make_optimizer", "make_train_step", "make_eval_step",
           "lr_schedule", "LR_HALFLIFE"]

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


def _to_device(batch: Dict, device: torch.device) -> Dict:
    return {key: torch.as_tensor(value).to(device)
            for key, value in batch.items()}


def _forward_loss(
    model: torch.nn.Module, batch: Dict, train: bool,
    generator: Optional[torch.Generator], compute_dtype: torch.dtype,
    plain_ops: bool, fused_ops: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss, score_sum, logits)``: the one forward of both steps."""
    logits = model(batch["images"], batch["questions"], batch["lengths"],
                   train=train, generator=generator,
                   compute_dtype=compute_dtype, plain_ops=plain_ops,
                   fused_ops=fused_ops)
    mask = batch.get("mask")
    loss = soft_cross_entropy(logits, batch["answer_indices"],
                              batch["answer_values"], mask)
    score = vqa_accuracy_sum(logits.detach(), batch["answer_indices"],
                             batch["answer_values"], mask)
    return loss, score, logits


def make_train_step(
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    accum_steps: int = 1,
    plain_ops: bool = False,
    fused_ops: bool = False,
):
    """Build ``train_step(state, batch, generator) -> (state, metrics)``.

    ``batch`` maps ``images``, ``questions``, ``lengths``,
    ``answer_indices``, ``answer_values`` and optionally ``mask`` to
    arrays or tensors, which the step moves to the device the model lies
    on (``create_train_state`` puts it on the GPU unless told otherwise);
    ``generator`` is the dropout generator, on that device. The step
    updates ``state`` in place and returns it with ``{"loss", "score"}``
    as 0-dim tensors on the device.

    ``accum_steps > 1`` splits the batch into that many micro-batches and
    accumulates their gradients before one update: activation memory is
    a micro-batch's, the update sees the whole batch's gradient, equal to
    the unaccumulated step up to the order of sums. The batch size must
    divide evenly; every micro-batch draws its own dropout masks.
    ``plain_ops=True`` runs the kernels' plain versions (the oracle);
    ``fused_ops=True`` flips the image encoder to its fused ops (see
    :meth:`VqaNet.forward`; the forward-only ones stay off while gradients
    are recorded).
    """
    cfg.check_ported()
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1, got {accum_steps}")

    def train_step(state: TrainState, batch: Dict,
                   generator: torch.Generator):
        device = next(state.model.parameters()).device
        batch = _to_device(batch, device)
        model, optimizer = state.model, state.optimizer
        optimizer.zero_grad(set_to_none=True)

        if accum_steps == 1:
            loss, score, _ = _forward_loss(model, batch, True, generator,
                                           compute_dtype, plain_ops,
                                           fused_ops)
            loss.backward()
            loss = loss.detach()
        else:
            batch_size = batch["questions"].shape[0]
            if batch_size % accum_steps != 0:
                raise ValueError(
                    f"batch size {batch_size} does not split into "
                    f"accum_steps={accum_steps} micro-batches")
            micro_size = batch_size // accum_steps
            loss_sum = torch.zeros((), device=device)
            score = torch.zeros((), device=device)
            n_total = torch.zeros((), device=device)
            for idx in range(accum_steps):
                rows = slice(idx * micro_size, (idx + 1) * micro_size)
                micro = {key: value[rows] for key, value in batch.items()}
                micro_loss, micro_score, _ = _forward_loss(
                    model, micro, True, generator, compute_dtype, plain_ops,
                    fused_ops)
                # A micro's loss is normalised by ITS real count (clamped
                # to 1 when all of it is padding). Averaging those would
                # misweight a padded final batch whose real samples fall
                # unevenly over the micros, so each goes back to sum form
                # here and the whole is normalised once, below, by the
                # batch's real count.
                if "mask" in micro:
                    n = micro["mask"].sum().float()
                else:
                    n = torch.tensor(float(micro_size), device=device)
                scale = n.clamp(min=1.0)
                (micro_loss * scale).backward()  # .grad accumulates
                loss_sum += micro_loss.detach() * scale
                score += micro_score
                n_total += n
            denom = n_total.clamp(min=1.0)
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(denom)
            loss = loss_sum / denom

        lr = lr_schedule(state.initial_lr)(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        state.step += 1
        return state, {"loss": loss, "score": score}

    return train_step


def make_eval_step(
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    with_breakdown: bool = False,
    plain_ops: bool = False,
    fused_ops: bool = False,
):
    """Build ``eval_step(model, batch) -> (loss, score_sum)``, 0-dim
    tensors on the model's device, to which the step moves the batch.
    ``with_breakdown=True`` also returns the per-answer-type (yes/no,
    number, other) score sums and counts, each ``[3]``, from
    ``batch["answer_types"]``."""
    cfg.check_ported()

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch: Dict):
        batch = _to_device(batch, next(model.parameters()).device)
        loss, score, logits = _forward_loss(model, batch, False, None,
                                            compute_dtype, plain_ops,
                                            fused_ops)
        if not with_breakdown:
            return loss, score
        sums, counts = vqa_accuracy_by_type(
            logits, batch["answer_indices"], batch["answer_values"],
            batch["answer_types"], batch.get("mask"))
        return loss, score, sums, counts

    return eval_step
