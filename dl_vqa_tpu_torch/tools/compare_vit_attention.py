#!/usr/bin/env python3
"""Time kernels 4 and 5 (ViT attention forward and backward) of several
source trees in turns on one card, and hold each to the plain versions.

    python3 -m dl_vqa_tpu_torch.tools.compare_vit_attention [--f32]
        [--shapes=H:D:S,...] [--rows=R,...] NAME=DIR [NAME=DIR ...]

Each DIR holds a version of ``vit_attention.cu``, ``vit_attention.cuh`` and
``vit_attention_backward.cu`` (for instance ``dl_vqa_tpu_torch/csrc``, or
the same three files of an older commit taken with ``git show``); the
shared headers come from ``dl_vqa_tpu_torch/csrc``. A version whose entries
take a plan gets the tree's (``ops/vit_attention.py::attention_plan``);
with ``--rows`` such a version also runs as NAME@R for each block size R
(64, 128, 192) of the wgmma design where the plan names it.
Every version is
compiled by ``nvcc -Xptxas -v`` (registers and spills are printed), run at
each shape of ``--shapes`` (H heads of size D at S tokens; default
``4:64:196``, the ViT's), bf16 (with ``--f32`` also
f32), B = 1, 8 and 512 on the same inputs, and timed with CUDA events in
the order given and back. For each it prints the largest difference from
the plain versions, the share of elements that differ, and whether its
bits equal the first version's.
Run from the repository root (DIRs are taken from there) on a machine with
an NVIDIA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch

from dl_vqa_tpu_torch.ops.vit_attention import (
    attention_plan, vit_attention_backward_reference, vit_attention_reference,
    wgmma_plan)
from dl_vqa_tpu_torch.tools._compare import build, card, timed

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = ("vit_attention.cu", "vit_attention_backward.cu")
_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the entries' dtype codes


def load(versions: dict, out_dir: str) -> dict:
    """name -> (library, whether its forward takes the SM count, whether
    both take the head size and scale, whether both take the plan of
    ``ops/vit_attention.py::attention_plan``)."""
    libs = {}
    for name, lib in build(versions, SOURCES, out_dir).items():
        with open(f"{versions[name]}/vit_attention.cu") as fd:
            source = fd.read()
        takes_sms = "int sms" in source  # newer versions
        takes_head = "float scale" in source  # heads of 64 n
        takes_plan = "int design" in source  # the wgmma design
        head = [_I, _F] if takes_head else []
        plan = [_I] * 8 if takes_plan else []
        lib.vqa_vit_attention.argtypes = [_P, _P, _I, _I, _I] + head + (
            [_I] if takes_sms else []) + [_I] + plan + [_P]
        lib.vqa_vit_attention_backward.argtypes = [_P, _P, _P, _P, _I, _I,
                                                   _I] + head + [_I] + plan \
            + [_P]
        libs[name] = (lib, takes_sms, takes_head, takes_plan)
    return libs


def main(argv) -> int:
    dtypes, shapes, rows_list = [torch.bfloat16], [(4, 64, 196)], []
    while argv and argv[0].startswith("--"):
        if argv[0] == "--f32":
            dtypes.append(torch.float32)
        elif argv[0].startswith("--rows="):
            rows_list = [int(r) for r in argv[0].split("=", 1)[1].split(",")]
        elif argv[0].startswith("--shapes="):
            shapes = [tuple(int(x) for x in shape.split(":"))
                      for shape in argv[0].split("=", 1)[1].split(",")]
        else:
            print(__doc__, file=sys.stderr)
            return 1
        argv = argv[1:]
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    versions = dict(arg.split("=", 1) for arg in argv)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as out_dir:
        libs = load(versions, out_dir)
        print(card())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def plan_args(name, qkv, heads, head):
            """The tree's plan for a version that takes one (NAME@R: with
            blocks of R rows)."""
            if not libs[name][3]:
                return [], qkv.shape[1]
            plan = attention_plan(qkv.dtype, head, qkv.shape[1],
                                  qkv.shape[0] * heads, sms)
            if "@" in name and plan.design == "wgmma":
                plan = wgmma_plan(head, qkv.shape[1],
                                  int(name.rsplit("@", 1)[1]))
            return list(plan.c_args()), max(plan.stats_len, 1)

        def forward(name, qkv, heads, head):
            lib, takes_sms, takes_head, _ = libs[name]
            out = torch.empty(*qkv.shape[:2], heads * head, dtype=qkv.dtype,
                              device="cuda")
            args = [qkv.data_ptr(), out.data_ptr(), *qkv.shape[:2],
                    heads] + ([head, 1.0 / head ** 0.5] if takes_head
                              else []) + ([sms] if takes_sms else [])
            plan, _ = plan_args(name, qkv, heads, head)
            assert lib.vqa_vit_attention(*args, _CODES[qkv.dtype], *plan,
                                         stream) == 0
            return out

        def backward(name, qkv, g, heads, head):
            lib, _, takes_head, _ = libs[name]
            dqkv = torch.empty_like(qkv)
            plan, stats_len = plan_args(name, qkv, heads, head)
            stats = torch.empty(qkv.shape[0], heads, 3, stats_len,
                                device="cuda")
            # The tree's one-grid path takes no statistics.
            stats_ptr = (None if plan and plan[-1] == 0
                         else stats.data_ptr())
            assert lib.vqa_vit_attention_backward(
                qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), stats_ptr,
                *qkv.shape[:2], heads,
                *([head, 1.0 / head ** 0.5] if takes_head else []),
                _CODES[qkv.dtype], *plan, stream) == 0
            return dqkv

        for name in list(libs):
            if libs[name][3]:
                for rows in rows_list:
                    libs[f"{name}@{rows}"] = libs[name]
        gen = torch.Generator(device="cuda").manual_seed(0)
        names = list(libs)
        for (heads, head, tokens), dtype, batch in (
                (s, d, b) for s in shapes for d in dtypes
                for b in (1, 8, 512)):
            width = heads * head
            qkv = torch.randn(batch, tokens, 3 * width, generator=gen,
                              device="cuda").to(dtype)
            g = torch.randn(batch, tokens, width, generator=gen,
                            device="cuda").to(dtype)
            want = (vit_attention_reference(qkv, heads),
                    vit_attention_backward_reference(qkv, g, heads))
            got = {n: (forward(n, qkv, heads, head),
                       backward(n, qkv, g, heads, head)) for n in names}
            label = f"{dtype} {heads}x{head} S={tokens} B={batch}"
            for n in names:
                parts = []
                for what, a, b, first in zip(("forward", "backward"), got[n],
                                             want, got[names[0]]):
                    parts.append(
                        f"{what} max_abs_err "
                        f"{float((a.float() - b.float()).abs().max()):.3e}, "
                        f"{float((a != b).float().mean()):.4%} differ, "
                        f"bits of {names[0]} {torch.equal(a, first)}")
                print(f"{label} {n}: " + " | ".join(parts))
            iters = 20 if batch == 512 else 200
            ms = {n: [0.0, 0.0] for n in names}
            for n in names + names[::-1]:
                ms[n][0] += timed(lambda: forward(n, qkv, heads, head),
                                  iters) / 2
                ms[n][1] += timed(lambda: backward(n, qkv, g, heads, head),
                                  iters) / 2
            for i, what in enumerate(("forward", "backward")):
                print(f"{label} {what} ms: " + ", ".join(
                    f"{n} {v[i]:.4f}" for n, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
