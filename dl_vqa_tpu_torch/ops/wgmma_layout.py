"""wgmma's 128-byte-swizzled, K-major shared-memory layout, in PyTorch.

Kernels 6 and 8 (``csrc/conv_relu_pool_fused.cu``, ``csrc/vit_mlp_fused.cu``)
read their weights by wgmma descriptors from shared memory, in the layout
that ``csrc/wgmma.cuh`` describes: a tile of R rows by K columns is K / 64
atoms one after the other, each R rows of 64 values (128 bytes), and inside
an atom the eight 16-byte pieces of row r are permuted, piece p lying at
piece ``p ^ (r % 8)``. Kernel 6's wrapper writes its weights in that order,
once a call, so that the kernel copies them into shared memory as they lie;
kernel 8's call packs its own on the card, :func:`swizzle_k_major` being
the plain version of that packing.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["ATOM", "swizzle_index", "swizzle_k_major"]

ATOM = 64  # values of a swizzled row: 128 bytes of bf16


@functools.lru_cache(maxsize=None)
def swizzle_index(rows: int, k: int, device: torch.device) -> torch.Tensor:
    """For each value of a swizzled ``[K / 64, R, 64]`` tile, the offset of
    its source in the row-major ``[R, K]`` matrix (built once a shape)."""
    atom = torch.arange(k // ATOM, device=device)[:, None, None]
    row = torch.arange(rows, device=device)[None, :, None]
    col = torch.arange(ATOM, device=device)[None, None, :]
    piece = (col // 8) ^ (row % 8)  # the piece that lands at col // 8
    return (row * k + atom * ATOM + piece * 8 + col % 8).reshape(-1)


def swizzle_k_major(t: torch.Tensor) -> torch.Tensor:
    """``t [..., R, K]`` (R a multiple of 8, K of 64) -> ``[..., K / 64, R,
    64]`` in the swizzled order, contiguous: one gather."""
    *lead, rows, k = t.shape
    if rows % 8 or k % ATOM:
        raise ValueError(f"a swizzled tile takes rows a multiple of 8 and "
                         f"K a multiple of {ATOM}; got {rows} x {k}")
    flat = t.reshape(-1, rows * k)
    out = flat.index_select(1, swizzle_index(rows, k, t.device))
    return out.reshape(*lead, k // ATOM, rows, ATOM)
