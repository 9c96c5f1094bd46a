"""Soft-target cross-entropy loss and the VQA accuracy metric, on the
tensors' device with no host sync.

Port of :mod:`dl_vqa_tpu.ops.vqa_metrics`, with the same semantics:

* loss: every ground-truth answer ``a`` of a sample with annotator count
  ``n_a`` contributes ``-log p(a) * n_a / 10``; the batch loss is the sum
  divided by the number of real samples (all of them without a mask; at
  least 1);
* accuracy: ``min(0.3 * count_of_argmax_answer, 1)`` per sample (the
  reference's 0.3 coefficient, not the official 1/3), summed over the batch;
* answer ids are 1-based with 0 = padding.

Everything is computed in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["soft_cross_entropy", "vqa_accuracy_sum", "vqa_accuracy_by_type",
           "vqa_batch_stats"]


def soft_cross_entropy(
    logits: torch.Tensor,          # [B, A] float
    answer_indices: torch.Tensor,  # [B, K] int, 1-based, 0 = pad
    answer_values: torch.Tensor,   # [B, K] int annotator counts, 0 = pad
    sample_mask: Optional[torch.Tensor] = None,  # [B] bool, False = padded
) -> torch.Tensor:
    """Soft-target NLL, summed over answers, divided by the number of
    real samples."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    indices = answer_indices.long()
    gathered = torch.gather(log_probs, 1, (indices - 1).clamp(min=0))
    weights = answer_values.float() / 10.0
    weights = torch.where(indices > 0, weights, torch.zeros_like(weights))
    per_sample = -(gathered * weights).sum(dim=-1)
    if sample_mask is None:
        return per_sample.sum() / per_sample.shape[0]
    per_sample = torch.where(sample_mask, per_sample,
                             torch.zeros_like(per_sample))
    return per_sample.sum() / sample_mask.sum().clamp(min=1)


def _scores(logits, answer_indices, answer_values, sample_mask):
    """Per-sample ``min(0.3 * agreeing count, 1)``, zero where masked."""
    predicted = torch.argmax(logits, dim=-1)  # 0-based answer id
    indices = answer_indices.long()
    hits = ((indices - 1) == predicted[:, None]) & (indices > 0)
    agreeing = torch.where(hits, answer_values,
                           torch.zeros_like(answer_values)).sum(dim=-1)
    score = (agreeing.float() * 0.3).clamp(max=1.0)
    if sample_mask is not None:
        score = torch.where(sample_mask, score, torch.zeros_like(score))
    return score


def vqa_accuracy_sum(
    logits: torch.Tensor, answer_indices: torch.Tensor,
    answer_values: torch.Tensor,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum over the batch of ``min(0.3 * agreeing_count, 1)``, where
    ``agreeing_count`` is the annotator count of the argmax answer."""
    return _scores(logits, answer_indices, answer_values, sample_mask).sum()


def vqa_accuracy_by_type(
    logits: torch.Tensor, answer_indices: torch.Tensor,
    answer_values: torch.Tensor,
    answer_types: torch.Tensor,    # [B] int: 0=yes/no, 1=number, 2=other
    sample_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-answer-type accuracy sums and counts of real samples, both
    ``[3]`` f32 (the VQA benchmark's yes/no, number, other breakdown)."""
    score = _scores(logits, answer_indices, answer_values, sample_mask)
    ones = torch.ones_like(score)
    if sample_mask is not None:
        ones = torch.where(sample_mask, ones, torch.zeros_like(ones))
    types = answer_types.long()
    sums = torch.zeros(3, dtype=score.dtype, device=score.device)
    counts = torch.zeros_like(sums)
    return sums.index_add_(0, types, score), counts.index_add_(0, types, ones)


def vqa_batch_stats(
    logits: torch.Tensor, answer_indices: torch.Tensor,
    answer_values: torch.Tensor,
    sample_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, score_sum)`` for one batch."""
    return (soft_cross_entropy(logits, answer_indices, answer_values,
                               sample_mask),
            vqa_accuracy_sum(logits, answer_indices, answer_values,
                             sample_mask))
