#!/usr/bin/env python3
"""Time kernels 1 and A (the LSTM recurrence, csrc/lstm_recurrence.cu) of
several source trees in turns on one card, and hold each to the plain
versions.

    python3 -m dl_vqa_tpu_torch.tools.compare_lstm NAME=DIR [...]

Each DIR holds a version of ``lstm_recurrence.cu`` (for instance
``dl_vqa_tpu_torch/csrc``, or the file of an older commit taken with
``git show``); the shared headers come from ``dl_vqa_tpu_torch/csrc``.
Every version is compiled by ``nvcc -Xptxas -v`` (registers and spills are
printed) and driven through this tree's wrappers (``ops/lstm_cuda.py``):
a version with the persistent entry takes it wherever ``persistent_plan``
finds a plan, and must share this tree's shared-memory layout (its entry
refuses another plan, and the call raises); an older one takes its
per-step grids. At T = 23, H = 1024, two directions, bf16, B = 1, 8, 64
and 512, on the same inputs, it prints for kernel 1 and kernel A the
largest difference from the plain versions and whether the bits equal the
first version's, then the times by CUDA events in the order given and
back. Run from the repository root (DIRs are taken from there) on a
machine with an NVIDIA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import tempfile

import torch

from dl_vqa_tpu_torch.ops import _native, lstm_cuda
from dl_vqa_tpu_torch.ops.lstm import (
    lstm_recurrence_reference, lstm_recurrence_save_reference)
from dl_vqa_tpu_torch.tools._compare import build, card, timed

SEQ_LEN, HIDDEN, DIRECTIONS = 23, 1024, 2
BATCHES = (1, 8, 64, 512)


def load(versions: dict, out_dir: str) -> dict:
    """name -> library, its entries declared as the package declares
    them."""
    libs = build(versions, ("lstm_recurrence.cu",), out_dir)
    for lib in libs.values():
        for entry, argtypes in _native._SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        lib.vqa_error_string.argtypes = [ctypes.c_int]
        lib.vqa_error_string.restype = ctypes.c_char_p
    return libs


@contextlib.contextmanager
def using(lib):
    """The package's wrappers on ``lib``; without the persistent entry,
    every call takes the per-step grids."""
    saved = _native._lib, lstm_cuda.persistent_plan
    _native._lib = lib
    if not hasattr(lib, "vqa_lstm_recurrence_persistent"):
        lstm_cuda.persistent_plan = lambda *args: None
    try:
        yield
    finally:
        _native._lib, lstm_cuda.persistent_plan = saved


def main(argv) -> int:
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    versions = dict(arg.split("=", 1) for arg in argv)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as out_dir:
        libs = load(versions, out_dir)
        plan = lstm_cuda.persistent_plan(DIRECTIONS, HIDDEN, torch.bfloat16,
                                         sms)
        print(f"{card()}; plan (units, blocks, shared bytes) at "
              f"D={DIRECTIONS}, H={HIDDEN}: {plan}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        names = list(versions)
        kernels = {"kernel 1": (lstm_cuda.lstm_recurrence_cuda,
                                lstm_recurrence_reference),
                   "kernel A": (lstm_cuda.lstm_recurrence_save_cuda,
                                lstm_recurrence_save_reference)}
        for batch in BATCHES:
            x_proj = (torch.randn(DIRECTIONS, SEQ_LEN, batch, 4 * HIDDEN,
                                  generator=gen, device="cuda") * 0.5
                      ).bfloat16()
            w_hh = ((torch.rand(DIRECTIONS, 4 * HIDDEN, HIDDEN, generator=gen,
                                device="cuda") * 2 - 1) / HIDDEN ** 0.5
                    ).bfloat16()
            lengths = torch.randint(1, SEQ_LEN + 1, (batch,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            lengths[-1] = SEQ_LEN
            args = (x_proj, w_hh, lengths)
            for what, (kernel, plain) in kernels.items():
                want = plain(*args)
                got = {}
                for n in names:
                    with using(libs[n]):
                        got[n] = kernel(*args)
                for n in names:
                    err = max(float((a - b).abs().max())
                              for a, b in zip(got[n], want))
                    same = all(torch.equal(a, b)
                               for a, b in zip(got[n], got[names[0]]))
                    print(f"B={batch} {what} {n}: max_abs_err {err:.3e}, "
                          f"bits of {names[0]} {same}")
                del got, want
                iters = 20 if batch == 512 else 100
                ms = dict.fromkeys(names, 0.0)
                for n in names + names[::-1]:
                    with using(libs[n]):
                        ms[n] += timed(lambda: kernel(*args), iters) / 2
                print(f"B={batch} {what} ms: " + ", ".join(
                    f"{n} {v:.4f}" for n, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
