"""Functions every part of the model shares: the JAX model's dropout, its
mixed-precision product, and the normalisation of uint8 images."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from dl_vqa_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD
from dl_vqa_tpu_torch.parallel.tensor import Shard, copy_to, take_columns

__all__ = ["dropout", "mm", "normalize_images", "BatchRows", "Drawn",
           "draw_masks"]


class BatchRows(NamedTuple):
    """A dropout source for rows ``[start, start + rows of x)`` of a batch
    of ``total`` rows: every site draws the whole batch's mask from
    ``generator`` and keeps these rows. A rank of a data-parallel step
    thus drops what one process dropping the whole batch drops, as the JAX
    step's masks do not depend on how its batch is sharded; the cost is
    the whole batch's random bytes drawn on every rank. ``tokens`` (a
    'seq' rank's ViT blocks): ``x``'s dim 1 holds tokens ``[token_start,
    token_start + tokens of x)`` of a sequence ``tokens`` long, and the
    mask is drawn for the whole sequence too."""

    generator: torch.Generator
    total: int
    start: int
    tokens: int = 0
    token_start: int = 0


class Drawn:
    """Dropout masks drawn ahead (:func:`draw_masks`), this rank's bytes of
    each site in the order the sites take them: a pipelined stage's
    microbatch draws nothing itself."""

    def __init__(self, bits: Sequence[torch.Tensor]):
        self.bits = list(bits)

    def take(self) -> torch.Tensor:
        return self.bits.pop(0)


def _threshold(rate: float) -> int:
    return int(round((1.0 - rate) * 256.0))


def _draws(rate: float, generator) -> bool:
    """Whether :func:`dropout` at ``rate`` draws from ``generator``."""
    return generator is not None and rate != 0.0 and \
        0 < _threshold(rate) < 256


def _bits(shape, device, generator: Union[torch.Generator, BatchRows]
          ) -> torch.Tensor:
    """The random bytes of a mask for an ``x`` of ``shape`` (this rank's
    rows and tokens of the whole batch's mask where ``generator`` is
    :class:`BatchRows`)."""
    if not isinstance(generator, BatchRows):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             generator=generator, device=device)
    whole = tuple(shape)
    if generator.tokens:
        whole = whole[:1] + (generator.tokens,) + whole[2:]
    bits = torch.randint(0, 256, (generator.total,) + whole[1:],
                         dtype=torch.uint8, generator=generator.generator,
                         device=device)
    bits = bits.narrow(0, generator.start, shape[0])
    if generator.tokens:
        bits = bits.narrow(1, generator.token_start, shape[1])
    return bits


def draw_masks(x: torch.Tensor, rate: float,
               generator: Union[None, torch.Generator, BatchRows],
               count: int) -> Optional[List[torch.Tensor]]:
    """The bytes of ``count`` dropout sites in a row, each for an ``x`` of
    ``x``'s shape, drawn as :func:`dropout` would draw them one after the
    other; None where :func:`dropout` draws nothing."""
    if not _draws(rate, generator):
        return None
    return [_bits(x.shape, x.device, generator) for _ in range(count)]


def normalize_images(images: torch.Tensor, dtype: torch.dtype
                     ) -> torch.Tensor:
    """uint8 pixels ``[B, H, W, 3]`` -> ImageNet-normalised ``dtype``
    values, computed in ``dtype``; any other tensor as it is."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=dtype, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=dtype, device=images.device)
    return (images.to(dtype) / 255.0 - mean) / std


def dropout(x: torch.Tensor, rate: float,
            generator: Union[None, torch.Generator, BatchRows],
            cols: Optional[Sequence[slice]] = None, width: int = 0
            ) -> torch.Tensor:
    """Inverted dropout with a uint8 mask source, as the JAX model's
    ``_dropout``: the keep probability is quantised to ``threshold / 256``
    with ``threshold = round((1 - rate) * 256)``, an element is kept where
    its random byte is below the threshold, and the kept ones are divided
    by the same quantised probability, so the mean is preserved exactly.
    ``generator`` is ``None`` in eval (no dropout), else a generator on
    ``x``'s device, or :class:`BatchRows` of one, or the masks of
    :class:`Drawn`. ``cols``: ``x`` holds
    these columns of a last dim ``width`` wide (a column-parallel
    activation): the mask is drawn at the whole width and those columns
    kept, so the ranks drop what one process drops."""
    if generator is None or rate == 0.0:
        return x
    threshold = _threshold(rate)
    if threshold >= 256:
        return x
    if threshold <= 0:
        return torch.zeros_like(x)
    if isinstance(generator, Drawn):
        bits = generator.take()
    else:
        shape = x.shape if cols is None else x.shape[:-1] + (width,)
        bits = _bits(shape, x.device, generator)
    bits = take_columns(bits, cols)
    return torch.where(bits < threshold, x / (threshold / 256.0), 0.0)


def mm(x: torch.Tensor, weight: torch.Tensor,
       tp: Optional[Shard] = None) -> torch.Tensor:
    """``x @ weight^T`` (torch layout ``[out, in]``) on operands rounded to
    x's dtype, with an f32 result, as ``preferred_element_type=float32``
    gives it: the product runs in f32, where products of bf16 operands are
    exact, and the result is not rounded back to bf16. ``tp``: ``weight``
    is this rank's rows of a column-parallel layer, so ``x``'s gradient is
    summed over the ranks (in f32, before any rounding to x's dtype)."""
    return torch.matmul(copy_to(x.float(), tp),
                        weight.to(x.dtype).float().t())
