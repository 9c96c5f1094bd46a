#!/usr/bin/env python3
"""Time kernels 4 and 5 (ViT attention forward and backward) of several
source trees in turns on one card, and hold each to the plain versions.

    python3 -m dl_vqa_tpu_torch.tools.compare_vit_attention NAME=DIR [...]

Each DIR holds a version of ``vit_attention.cu``, ``vit_attention.cuh`` and
``vit_attention_backward.cu`` (for instance ``dl_vqa_tpu_torch/csrc``, or
the same three files of an older commit taken with ``git show``); the
shared headers come from ``dl_vqa_tpu_torch/csrc``. Every version is
compiled by ``nvcc -Xptxas -v`` (registers and spills are printed), run at
S = 196, H = 4, bf16, B = 1, 8 and 512 on the same inputs, and timed with
CUDA events in the order given and back. For each it prints the largest
difference from the plain versions, the share of elements that differ, and
whether its bits equal the first version's. Run from the repository root
(DIRs are taken from there) on a machine with an NVIDIA GPU and nvcc;
imports no JAX.
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch

from dl_vqa_tpu_torch.ops.vit_attention import (
    vit_attention_backward_reference, vit_attention_reference)
from dl_vqa_tpu_torch.tools._compare import build, card, timed

HEADS, TOKENS, WIDTH = 4, 196, 256
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES = ("vit_attention.cu", "vit_attention_backward.cu")


def load(versions: dict, out_dir: str) -> dict:
    """name -> (library, whether its forward takes the SM count)."""
    libs = {}
    for name, lib in build(versions, SOURCES, out_dir).items():
        with open(f"{versions[name]}/vit_attention.cu") as fd:
            takes_sms = "int sms" in fd.read()  # newer versions
        lib.vqa_vit_attention.argtypes = [_P, _P, _I, _I, _I] + (
            [_I] if takes_sms else []) + [_I, _P]
        lib.vqa_vit_attention_backward.argtypes = [_P, _P, _P, _P, _I, _I,
                                                   _I, _I, _P]
        libs[name] = (lib, takes_sms)
    return libs


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    versions = dict(arg.split("=", 1) for arg in argv)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as out_dir:
        libs = load(versions, out_dir)
        print(card())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def forward(name, qkv):
            lib, takes_sms = libs[name]
            out = torch.empty(*qkv.shape[:2], WIDTH, dtype=qkv.dtype,
                              device="cuda")
            args = [qkv.data_ptr(), out.data_ptr(), qkv.shape[0], TOKENS,
                    HEADS] + ([sms] if takes_sms else [])
            assert lib.vqa_vit_attention(*args, 1, stream) == 0
            return out

        def backward(name, qkv, g):
            lib, _ = libs[name]
            dqkv = torch.empty_like(qkv)
            stats = torch.empty(qkv.shape[0], HEADS, 3, TOKENS, device="cuda")
            assert lib.vqa_vit_attention_backward(
                qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                stats.data_ptr(), qkv.shape[0], TOKENS, HEADS, 1,
                stream) == 0
            return dqkv

        gen = torch.Generator(device="cuda").manual_seed(0)
        names = list(versions)
        for batch in (1, 8, 512):
            qkv = torch.randn(batch, TOKENS, 3 * WIDTH, generator=gen,
                              device="cuda").bfloat16()
            g = torch.randn(batch, TOKENS, WIDTH, generator=gen,
                            device="cuda").bfloat16()
            want = (vit_attention_reference(qkv, HEADS),
                    vit_attention_backward_reference(qkv, g, HEADS))
            got = {n: (forward(n, qkv), backward(n, qkv, g)) for n in names}
            for n in names:
                parts = []
                for what, a, b, first in zip(("forward", "backward"), got[n],
                                             want, got[names[0]]):
                    parts.append(
                        f"{what} max_abs_err "
                        f"{float((a.float() - b.float()).abs().max()):.3e}, "
                        f"{float((a != b).float().mean()):.4%} differ, "
                        f"bits of {names[0]} {torch.equal(a, first)}")
                print(f"B={batch} {n}: " + " | ".join(parts))
            iters = 20 if batch == 512 else 200
            ms = {n: [0.0, 0.0] for n in names}
            for n in names + names[::-1]:
                ms[n][0] += timed(lambda: forward(n, qkv), iters) / 2
                ms[n][1] += timed(lambda: backward(n, qkv, g), iters) / 2
            for i, what in enumerate(("forward", "backward")):
                print(f"B={batch} {what} ms: " + ", ".join(
                    f"{n} {v[i]:.4f}" for n, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
