"""wgmma's 128-byte-swizzled, K-major shared-memory layout, in PyTorch.

Kernels 6, 8 and D (``csrc/conv_relu_pool_fused.cu``,
``csrc/vit_mlp_fused.cu``, ``csrc/conv_relu_pool_int8.cu``) read their
weights by wgmma descriptors from shared memory, in the layout that
``csrc/wgmma.cuh`` describes: a tile of R rows by K columns is K / A atoms
one after the other, each R rows of 128 bytes (A = 64 bf16 or 128 s8
values), and inside an atom the eight 16-byte pieces of row r are
permuted, piece p lying at piece ``p ^ (r % 8)``. Kernels 6 and D's
wrappers write their weights in that order, once a call, so that the
kernel copies them into shared memory as they lie; kernel 8's call packs
its own on the card, :func:`swizzle_k_major` being the plain version of
that packing.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["ATOM", "ATOM_BYTES", "swizzle_index", "swizzle_k_major"]

ATOM_BYTES = 128  # bytes of a swizzled row
ATOM = 64  # values of a swizzled row: 128 bytes of bf16


@functools.lru_cache(maxsize=None)
def swizzle_index(rows: int, k: int, device: torch.device,
                  itemsize: int = 2) -> torch.Tensor:
    """For each value of a swizzled ``[K / A, R, A]`` tile of
    ``itemsize``-byte values (A = 128 / itemsize values a row), the offset
    of its source in the row-major ``[R, K]`` matrix (built once a
    shape)."""
    atom_values, piece_values = ATOM_BYTES // itemsize, 16 // itemsize
    atom = torch.arange(k // atom_values, device=device)[:, None, None]
    row = torch.arange(rows, device=device)[None, :, None]
    col = torch.arange(atom_values, device=device)[None, None, :]
    piece = (col // piece_values) ^ (row % 8)  # lands at col // piece_values
    return (row * k + atom * atom_values + piece * piece_values
            + col % piece_values).reshape(-1)


def swizzle_k_major(t: torch.Tensor, itemsize: int = 2) -> torch.Tensor:
    """``t [..., R, K]`` (R a multiple of 8, K of A = 128 / ``itemsize``)
    -> ``[..., K / A, R, A]`` in the swizzled order of ``itemsize``-byte
    values (whatever ``t``'s own dtype), contiguous: one gather."""
    *lead, rows, k = t.shape
    atom_values = ATOM_BYTES // itemsize
    if rows % 8 or k % atom_values:
        raise ValueError(f"a swizzled tile takes rows a multiple of 8 and "
                         f"K a multiple of {atom_values}; got {rows} x {k}")
    flat = t.reshape(-1, rows * k)
    out = flat.index_select(1, swizzle_index(rows, k, t.device, itemsize))
    return out.reshape(*lead, k // atom_values, rows, atom_values)
