"""Two functions every part of the model shares: the JAX model's dropout
and its mixed-precision product."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dropout", "mm"]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a uint8 mask source, as the JAX model's
    ``_dropout``: the keep probability is quantised to ``threshold / 256``
    with ``threshold = round((1 - rate) * 256)``, an element is kept where
    its random byte is below the threshold, and the kept ones are divided
    by the same quantised probability, so the mean is preserved exactly.
    ``generator`` is ``None`` in eval (no dropout), else a generator on
    ``x``'s device."""
    if generator is None or rate == 0.0:
        return x
    threshold = int(round((1.0 - rate) * 256.0))
    if threshold >= 256:
        return x
    if threshold <= 0:
        return torch.zeros_like(x)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                         generator=generator, device=x.device)
    return torch.where(bits < threshold, x / (threshold / 256.0), 0.0)


def mm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight^T`` (torch layout ``[out, in]``) on operands rounded to
    x's dtype, with an f32 result, as ``preferred_element_type=float32``
    gives it: the product runs in f32, where products of bf16 operands are
    exact, and the result is not rounded back to bf16."""
    return torch.matmul(x.float(), weight.to(x.dtype).float().t())
