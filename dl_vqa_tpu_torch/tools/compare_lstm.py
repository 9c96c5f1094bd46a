#!/usr/bin/env python3
"""Time kernels 1 and A (the LSTM recurrence, csrc/lstm_recurrence.cu) and
kernel B (the LSTM backward step, csrc/lstm_backward.cu) of several
source trees in turns on one card, and hold each to the plain versions.

    python3 -m dl_vqa_tpu_torch.tools.compare_lstm [--kernels=1A,B] \
        NAME=DIR [...]

``--kernels`` picks what to time: ``1A`` (kernels 1 and A), ``B``, or both
(the default). Each DIR holds a version of the two files (for instance
``dl_vqa_tpu_torch/csrc``, or the files of an older commit taken with
``git show``); the shared headers come from ``dl_vqa_tpu_torch/csrc``.
Every version is compiled by ``nvcc -Xptxas -v`` (registers and spills are
printed) and driven through this tree's wrappers (``ops/lstm_cuda.py``):
a version with the persistent entry takes it wherever ``persistent_plan``
finds a plan, and must share this tree's shared-memory layout (its entry
refuses another plan, and the call raises); an older one takes its
per-step grids. The same holds in f32 for the f32 persistent entry and
``f32_plan``. At T = 23, H = 1024, two directions, B = 1, 8, 64 and 512,
on the same inputs, it prints for kernel 1 and kernel A in bf16, for both
in f32 and for the f32 token states the largest difference from the plain
versions and whether the bits equal the first version's, then the times
by CUDA events in the order given and back. Kernel B runs at B = 512 on
the saved states of a bf16 forward with ragged lengths: each version's 23
steps, each fed the plain step's inputs,
against the plain bits (max_abs_err), whether it took a vector kernel
(a version with ``vqa_lstm_backward_step_vector``), then in turns the 23
launches through the entry a backward uses (checked once), through the
wrapper that checks every call, the same 23 launches replayed from a CUDA
graph (the device's time, no host work), and the whole backward with its
products, beside the bound. A version with
``vqa_lstm_backward_step_chained`` (a design that launched every step of
a backward after its first as a programmatic dependent launch, which may
start while the launch before it finishes) takes that entry there. Run
from the repository root (DIRs are taken from there) on a machine with an
NVIDIA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import tempfile

import torch

from dl_vqa_tpu_torch.ops import _native, lstm_cuda
from dl_vqa_tpu_torch.ops.lstm import (
    lstm_backward_step_reference, lstm_recurrence_reference,
    lstm_recurrence_save_reference, lstm_saved_state_backward,
    lstm_token_states_reference)
from dl_vqa_tpu_torch.tools._compare import build, card, timed

SEQ_LEN, HIDDEN, DIRECTIONS = 23, 1024, 2
BATCHES = (1, 8, 64, 512)
HBM_BYTES_PER_S = 3.35e12


def load(versions: dict, out_dir: str) -> dict:
    """name -> library, its entries declared as the package declares
    them."""
    libs = build(versions, ("lstm_recurrence.cu", "lstm_backward.cu"),
                 out_dir)
    for lib in libs.values():
        for entry, argtypes in _native._SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        lib.vqa_error_string.argtypes = [ctypes.c_int]
        lib.vqa_error_string.restype = ctypes.c_char_p
    return {name: Chained(lib)
            if hasattr(lib, "vqa_lstm_backward_step_chained") else lib
            for name, lib in libs.items()}


class Chained:
    """A version with a chained step entry: the step entry, which the
    launcher fetches once a backward, launches its first step unchained and
    every later one chained, as that version's backward did."""

    def __init__(self, lib):
        self.lib = lib
        chained = lib.vqa_lstm_backward_step_chained
        chained.argtypes = lib.vqa_lstm_backward_step.argtypes
        chained.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)

    @property
    def vqa_lstm_backward_step(self):
        entries = [self.lib.vqa_lstm_backward_step]

        def step(*args):
            code = entries[-1](*args)
            entries[-1] = self.lib.vqa_lstm_backward_step_chained
            return code

        return step


@contextlib.contextmanager
def using(lib):
    """The package's wrappers on ``lib``; without the persistent entry,
    every bf16 call takes the per-step grids, and without the f32
    persistent entry every f32 call."""
    saved = _native._lib, lstm_cuda.persistent_plan, lstm_cuda.f32_plan
    _native._lib = lib
    if not hasattr(lib, "vqa_lstm_recurrence_persistent"):
        lstm_cuda.persistent_plan = lambda *args: None
    if not hasattr(lib, "vqa_lstm_recurrence_f32"):
        lstm_cuda.f32_plan = lambda *args, **kwargs: None
    try:
        yield
    finally:
        (_native._lib, lstm_cuda.persistent_plan,
         lstm_cuda.f32_plan) = saved


class WithLstmOf:
    """The package's library with the LSTM entries (``vqa_lstm_*``) of
    another version's: a whole model runs on the package's other kernels
    and that version's recurrence and backward step. An entry the version
    lacks is missing here too, so that :func:`using` sees it."""

    def __init__(self, lstm_lib, base):
        self.lstm_lib, self.base = lstm_lib, base

    def __getattr__(self, name):
        if name.startswith("vqa_lstm_") or name == "vqa_error_string":
            return getattr(self.lstm_lib, name)
        return getattr(self.base, name)


def main(argv) -> int:
    picked = {"1A", "B"}
    if argv and argv[0].startswith("--kernels="):
        picked = set(argv[0].split("=", 1)[1].split(","))
        argv = argv[1:]
    if (not argv or not torch.cuda.is_available()
            or not picked <= {"1A", "B"}):
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
        if "1A" in picked:
            recurrence(libs, list(versions), gen)
        if "B" in picked:
            backward_step(libs, list(versions), gen)
    return 0


def recurrence(libs, names, gen):
    """Kernels 1 and A of each version at B = 1, 8, 64 and 512, in bf16
    and in f32, and the f32 token states (``vqa::lstm_token_states``)."""
    kernels = {"kernel 1": (lstm_cuda.lstm_recurrence_cuda,
                            lstm_recurrence_reference),
               "kernel A": (lstm_cuda.lstm_recurrence_save_cuda,
                            lstm_recurrence_save_reference)}
    f32 = {"kernel 1 f32": kernels["kernel 1"],
           "kernel A f32": kernels["kernel A"],
           "token states f32": (
               lambda *args: _token_states(lstm_cuda.lstm_token_states_cuda(
                   *args)),
               lstm_token_states_reference)}
    for batch in BATCHES:
        x_proj, w_hh, lengths = inputs(gen, batch)
        for kinds, args in (
                (kernels, (x_proj, w_hh, lengths)),
                (f32, (x_proj.float(), w_hh.float(), lengths))):
            compare(libs, names, kinds, args, batch)


def _token_states(out):
    """The token states' ``(h_all, c)`` of the wrapper's five outputs."""
    return out[4], out[1]


def compare(libs, names, kernels, args, batch):
    """Each kernel of ``kernels`` (name -> (wrapper, plain version)) on
    every version: its largest difference from the plain version, whether
    its bits are the first version's, then its time in turns."""
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
        iters = 20 if batch == 512 and "f32" not in what else (
            5 if batch == 512 else 100)
        ms = dict.fromkeys(names, 0.0)
        for n in names + names[::-1]:
            with using(libs[n]):
                ms[n] += timed(lambda: kernel(*args), iters) / 2
        print(f"B={batch} {what} ms: " + ", ".join(
            f"{n} {v:.4f}" for n, v in ms.items()))


def inputs(gen, batch):
    x_proj = (torch.randn(DIRECTIONS, SEQ_LEN, batch, 4 * HIDDEN,
                          generator=gen, device="cuda") * 0.5).bfloat16()
    w_hh = ((torch.rand(DIRECTIONS, 4 * HIDDEN, HIDDEN, generator=gen,
                        device="cuda") * 2 - 1) / HIDDEN ** 0.5).bfloat16()
    lengths = torch.randint(1, SEQ_LEN + 1, (batch,), generator=gen,
                            device="cuda", dtype=torch.int32)
    lengths[-1] = SEQ_LEN
    return x_proj, w_hh, lengths


def backward_step(libs, names, gen):
    """Kernel B of each version at B = 512 on a bf16 forward's saved
    states, with the f32 master W_hh of the whole backward."""
    batch = 512
    x_proj, w_hh, lengths = inputs(gen, batch)
    _, _, gates, c_all, h_all = lstm_recurrence_save_reference(
        x_proj, w_hh, lengths)
    master = w_hh.float()
    dh = torch.randn(DIRECTIONS, batch, HIDDEN, generator=gen, device="cuda")
    dc = torch.randn(DIRECTIONS, batch, HIDDEN, generator=gen, device="cuda")
    keep_all = (torch.arange(SEQ_LEN, device="cuda")[:, None]
                < lengths[None, :])
    zeros = torch.zeros_like(dh)
    dgates = torch.empty_like(gates)
    real = float(lengths.sum()) / (SEQ_LEN * batch)
    moved = (real * (gates.numel() + c_all.numel()) * 4 + gates.numel() * 4
             + lengths.numel() * 4 + 4 * dh.numel() * 4)
    print(f"kernel B, B={batch} T={SEQ_LEN} H={HIDDEN} D={DIRECTIONS}: real "
          f"rows {real:.3f}, bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms by "
          f"bytes ({moved / 1e9:.3f} GB)")
    runs = {}
    for n in names:
        lib = libs[n]
        vector = (hasattr(lib, "vqa_lstm_backward_step_vector")
                  and lib.vqa_lstm_backward_step_vector(
                      gates.data_ptr(), c_all.data_ptr(), dh.data_ptr(),
                      dc.data_ptr(), dgates.data_ptr(), DIRECTIONS, batch,
                      HIDDEN))
        err, dh_t, dc_t = 0.0, dh, dc
        with using(lib):
            for t in reversed(range(SEQ_LEN)):
                want = lstm_backward_step_reference(
                    gates[:, t], c_all[:, t], c_all[:, t - 1] if t else zeros,
                    keep_all[t], dh_t, dc_t)
                dh_k, dc_k = dh_t.clone(), dc_t.clone()
                lstm_cuda.lstm_backward_step_cuda(gates, c_all, lengths, dh_k,
                                                  dc_k, dgates, t)
                err = max(err, *(float((a - b).abs().max()) for a, b in zip(
                    (dgates[:, t], dh_k, dc_k), want)))
                dh_t, dc_t = want[1:]
        print(f"kernel B {n}: vector kernel {bool(vector)}, every step "
              f"against the plain step's bits: max_abs_err {err:.3e}")

        def thin(lib=lib):
            with using(lib):
                dh_k, dc_k = dh.clone(), dc.clone()
                launch = lstm_cuda.lstm_backward_step_launcher(
                    gates, c_all, lengths, dh_k, dc_k, dgates)
                for t in reversed(range(SEQ_LEN)):
                    launch(t)

        def checked(lib=lib):
            with using(lib):
                dh_k, dc_k = dh.clone(), dc.clone()
                for t in reversed(range(SEQ_LEN)):
                    lstm_cuda.lstm_backward_step_cuda(gates, c_all, lengths,
                                                      dh_k, dc_k, dgates, t)

        def whole(lib=lib):
            with using(lib):
                lstm_saved_state_backward(gates, c_all, h_all, master,
                                          lengths, dh, dc, plain=False)

        graph = torch.cuda.CUDAGraph()
        thin()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            thin()
        runs[n] = {"thin": thin, "checked": checked, "graph": graph.replay,
                   "whole": whole}
    for what in ("thin", "checked", "graph", "whole"):
        iters = 5 if what == "whole" else 50
        ms = dict.fromkeys(names, 0.0)
        for n in names + names[::-1]:
            ms[n] += timed(runs[n][what], iters) / 2
        print(f"kernel B {what} ms: " + ", ".join(
            f"{n} {v:.4f} ({moved / HBM_BYTES_PER_S * 1e3 / v:.0%} of the "
            f"bound)" if what != "whole" else f"{n} {v:.4f}"
            for n, v in ms.items()))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
