"""The LSTM's kernels on Hopper: the masked recurrence (kernel 1), its
save mode (kernel A, both ``csrc/lstm_recurrence.cu``) and the backward
step (kernel B, ``csrc/lstm_backward.cu``).

Kernel 1 replaces ``dl_vqa_tpu/ops/lstm_pallas.py::_lstm_kernel`` (the
non-save mode of ``_lstm_scan_pallas_impl``), kernel A
``::_lstm_kernel_save``, and kernel B the body of
``::_lstm_saved_state_bwd.step``, which the JAX package leaves to XLA.
Their plain PyTorch versions are ``lstm_recurrence_reference``,
``lstm_recurrence_save_reference`` and ``lstm_backward_step_reference``
in :mod:`dl_vqa_tpu_torch.ops.lstm`.

What bounds it on this card: the recurrence is serial in T, and each step
is a ``[B, H] x [H, 4H]`` product against all of W_hh (8 MB per direction
in bf16). The TPU kernel kept W_hh in VMEM across one sequential grid.
Here, by a rule on dtype and shape decided before the launch
(:func:`persistent_plan`):

* **bf16 with a plan: one persistent launch a call.** A cooperative grid
  of one block per SM at most; each block owns ``units`` hidden units of
  one direction and keeps their ``4 x units`` rows of W_hh in shared
  memory for all T steps (128 KiB at H = 1024, two directions, 16 units on
  128 blocks). Each step it streams its direction's bf16 h from L2, runs
  the product by ``mma.sync`` and the cell update in registers, and waits
  at one barrier per step for the direction's other blocks. At batch 512
  each block reads 1 MiB of h from L2 a step. A refused launch raises;
  nothing falls back.
* **f32, and bf16 shapes with no plan: one grid per step** (both
  directions in each launch). W_hh stays in the 50 MB L2 between the T
  launches and every block re-reads its 16 rows of each gate from L2 (for
  64 batch rows at once when the batch exceeds 64); bf16 on the tensor
  cores (wmma), f32 by plain FMAs. Every block also reads all of h, so
  each step writes h rounded to bf16 beside the f32 h for the next step to
  stage. h is double-buffered between launches; c is updated in place,
  one owner per element.

Kernel A is the same step with three more stores per element: the f32
gates (386 MB at batch 512, T=23, H=1024, two directions) and the masked
f32 carries (96 MB each). Kernel B is pure traffic, one grid per reverse
step for both directions: a real row reads its gates, two carries and
``(dh, dc)`` and writes its ``dgates`` and ``(dh, dc)``; a padded row only
writes zero ``dgates`` (a step at batch 512 moves 59 MB where every row
is real, 17 MB where every row is padded). It moves 16-byte
vectors where :func:`backward_step_vector_path` says so (the model's
shapes). The recurrent product between two steps is a plain
``torch.baddbmm``. A backward checks its tensors once
(:func:`lstm_backward_step_launcher`) and then only launches, a grid a
step; :func:`lstm_backward_step_cuda` checks on every call.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from dl_vqa_tpu_torch.ops import _native

__all__ = ["lstm_recurrence_cuda", "lstm_recurrence_save_cuda",
           "lstm_backward_step_cuda", "lstm_backward_step_launcher",
           "backward_step_vector_path", "backward_step_vector_accesses",
           "persistent_plan", "persistent_smem_bytes", "SMEM_PER_BLOCK",
           "BACKWARD_THREADS", "BACKWARD_VECTOR_FLOATS",
           "BACKWARD_MAX_VECTOR_THREADS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_UNITS = 16  # hidden units per block (csrc/lstm_recurrence.cu kUnits)

# The persistent kernel's layout (csrc/lstm_recurrence.cu, namespace
# persistent): 16 warps a block, each row group stages up to 32 rows (two
# tiles) of 64 columns of h in each of 2 stages; rows padded by 8 bf16
# values.
_WARPS, _ROWS, _CHUNK, _STAGES, _PAD = 16, 32, 64, 2, 8
# Shared memory a block of an H100 (sm_90) may use.
SMEM_PER_BLOCK = 232_448
# Kernel B's vector kernel (csrc/lstm_backward.cu): threads a block
# (kThreads), f32 units a thread (kVectorFloats), threads a call may have
# (kMaxVectorThreads).
BACKWARD_THREADS = 256
BACKWARD_VECTOR_FLOATS = 4
BACKWARD_MAX_VECTOR_THREADS = 2 ** 31


def persistent_smem_bytes(units: int, hidden: int) -> int:
    """Dynamic shared memory of a persistent block: its W_hh rows, then
    one ring of h chunks per row group (a row group is the ``units / 8``
    warps that share batch rows; a block has ``16 / (units / 8)``)."""
    row_groups = _WARPS * 8 // units
    return (4 * units * (hidden + _PAD) * 2
            + row_groups * _STAGES * _ROWS * (_CHUNK + _PAD) * 2)


def persistent_plan(directions: int, hidden: int, dtype: torch.dtype,
                    sm_count: int) -> Optional[Tuple[int, int, int]]:
    """``(units, blocks, smem_bytes)`` of the persistent kernel, or None
    where the call takes the per-step grids.

    Only bf16 has a plan: f32's W_hh (32 MiB at H = 1024, two directions)
    fits on no card's shared memory. ``units``, the hidden units a block
    owns, is the smallest of 8, 16, 32 and 64 that divides ``hidden`` with
    every block resident at once, one an SM (``directions * hidden /
    units <= sm_count``), and its W_hh rows and ring within
    :data:`SMEM_PER_BLOCK`. The plan does not depend on the batch, so
    neither do a row's bits."""
    if dtype != torch.bfloat16 or directions < 1 or hidden % 16:
        return None
    for units in (8, 16, 32, 64):
        blocks = directions * hidden // units
        smem = persistent_smem_bytes(units, hidden)
        if (hidden % units == 0 and blocks <= sm_count
                and smem <= SMEM_PER_BLOCK):
            return units, blocks, smem
    return None


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_recurrence_args(x_proj, weight_hh, lengths):
    """Raise on anything kernels 1 and A do not take; returns ``(D, T, B,
    H)``."""
    if x_proj.dim() != 4 or weight_hh.dim() != 3 or lengths.dim() != 1:
        raise ValueError(
            f"expected x_proj [D,T,B,4H], weight_hh [D,4H,H], lengths [B]; "
            f"got {tuple(x_proj.shape)}, {tuple(weight_hh.shape)}, "
            f"{tuple(lengths.shape)}")
    directions, seq_len, batch, four_h = x_proj.shape
    hidden = weight_hh.shape[-1]
    if (four_h != 4 * hidden
            or tuple(weight_hh.shape) != (directions, 4 * hidden, hidden)
            or lengths.shape[0] != batch):
        raise ValueError(
            f"shape mismatch: x_proj {tuple(x_proj.shape)}, weight_hh "
            f"{tuple(weight_hh.shape)}, lengths {tuple(lengths.shape)}")
    if hidden % _UNITS:
        raise ValueError(f"hidden size {hidden} is not a multiple of {_UNITS}")
    _check_cuda_contiguous(x_proj, x_proj=x_proj, weight_hh=weight_hh,
                           lengths=lengths)
    if x_proj.dtype not in _DTYPES or weight_hh.dtype != x_proj.dtype:
        raise ValueError(
            f"x_proj and weight_hh must share a dtype in {list(_DTYPES)}; "
            f"got {x_proj.dtype}, {weight_hh.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    if weight_hh.data_ptr() % 32:
        raise ValueError("weight_hh must be 32-byte aligned")
    if x_proj.data_ptr() % 4:
        raise ValueError("x_proj must be 4-byte aligned")
    return directions, seq_len, batch, hidden


def _check_cuda_contiguous(first, **tensors):
    for name, t in tensors.items():
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{name} must be a CUDA tensor on one device; "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _run_recurrence(x_proj, weight_hh, lengths, save):
    directions, seq_len, batch, hidden = _check_recurrence_args(
        x_proj, weight_hh, lengths)
    lib = _native.library()
    device = x_proj.device
    saved = ()
    if save:
        saved = tuple(
            torch.empty(directions, seq_len, batch, width,
                        dtype=torch.float32, device=device)
            for width in (4 * hidden, hidden, hidden))
    name = "lstm_recurrence_save" if save else "lstm_recurrence"
    stream = _native.stream_ptr(device)
    plan = persistent_plan(directions, hidden, x_proj.dtype,
                           _sm_count(device))
    if plan is not None:
        units, _, smem = plan
        h = torch.zeros(directions, batch, hidden, dtype=torch.float32,
                        device=device)
        c = torch.zeros_like(h)
        # Step t reads hq[t % 2] from step t - 1 (step 0 reads nothing).
        hq = torch.empty(2, directions, batch, hidden, dtype=x_proj.dtype,
                         device=device)
        barrier = torch.zeros(directions, dtype=torch.int32, device=device)
        code = lib.vqa_lstm_recurrence_persistent(
            x_proj.data_ptr(), weight_hh.data_ptr(), lengths.data_ptr(),
            h.data_ptr(), c.data_ptr(), hq.data_ptr(), barrier.data_ptr(),
            *((s.data_ptr() for s in saved) if save else (None,) * 3),
            directions, seq_len, batch, hidden, units, smem, int(save),
            stream)
        _native.check(name, code)
        launched = 1 if batch and directions and seq_len else 0
        return (h, c) + saved, launched
    h = torch.zeros(2, directions, batch, hidden, dtype=torch.float32,
                    device=device)
    c = torch.zeros(directions, batch, hidden, dtype=torch.float32,
                    device=device)
    # h rounded to the weight dtype, double-buffered like h; f32 uses h.
    hq = h if x_proj.dtype == torch.float32 else torch.zeros(
        2, directions, batch, hidden, dtype=x_proj.dtype, device=device)
    pointers = (x_proj.data_ptr(), weight_hh.data_ptr(), lengths.data_ptr(),
                h[0].data_ptr(), h[1].data_ptr(), hq[0].data_ptr(),
                hq[1].data_ptr(), c.data_ptr())
    sizes = (directions, seq_len, batch, hidden, _DTYPES[x_proj.dtype],
             stream)
    if save:
        code = lib.vqa_lstm_recurrence_save(
            *pointers, *(s.data_ptr() for s in saved), *sizes)
    else:
        code = lib.vqa_lstm_recurrence(*pointers, *sizes)
    _native.check(name, code)
    # The C entry launches one grid per timestep (none for an empty batch).
    launched = seq_len if batch and directions else 0
    return (h[seq_len % 2], c) + saved, launched


def lstm_recurrence_cuda(
    x_proj: torch.Tensor,     # [D, T, B, 4H], bf16 or f32
    weight_hh: torch.Tensor,  # [D, 4H, H], same dtype
    lengths: torch.Tensor,    # [B] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1: final f32 ``(h, c)``, each ``[D, B, H]``, computed on
    ``x_proj``'s device. Raises on any input it does not take."""
    out, launched = _run_recurrence(x_proj, weight_hh, lengths, save=False)
    lstm_recurrence_cuda.launches += launched
    return out


lstm_recurrence_cuda.launches = 0


def lstm_recurrence_save_cuda(
    x_proj: torch.Tensor, weight_hh: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Kernel A: ``(h, c, gates_all [D, T, B, 4H], c_all, h_all [D, T, B,
    H])``, all f32; ``h`` and ``c`` are kernel 1's bits."""
    out, launched = _run_recurrence(x_proj, weight_hh, lengths, save=True)
    lstm_recurrence_save_cuda.launches += launched
    return out


lstm_recurrence_save_cuda.launches = 0


def backward_step_vector_path(directions: int, batch: int, hidden: int,
                              pointers=()) -> bool:
    """Whether kernel B runs its vector kernel: the mirror of
    ``vector_path`` in ``csrc/lstm_backward.cu``. H is a multiple of the
    4 f32 units a thread makes, the threads (``D * B * H / 4``) fit 31
    bits, and every pointer of ``gates_all``, ``c_all``, ``dh``, ``dc`` and
    ``dgates_all`` sits on a 16-byte boundary (so then does every row)."""
    return (hidden % BACKWARD_VECTOR_FLOATS == 0
            and directions * batch * (hidden // BACKWARD_VECTOR_FLOATS)
            < BACKWARD_MAX_VECTOR_THREADS
            and all(p % (4 * BACKWARD_VECTOR_FLOATS) == 0 for p in pointers))


def backward_step_vector_accesses(directions: int, seq_len: int, batch: int,
                                  hidden: int, t: int, lengths) -> list:
    """The vector kernel's work at step ``t``, as it computes its offsets:
    for each thread of its grid (``BACKWARD_THREADS`` a block), the 16-byte
    vectors it touches as ``(tensor, "read" or "write", first element)``,
    offsets in f32 elements of ``gates_all``, ``c_all``, ``dh``, ``dc`` or
    ``dgates_all``. A padded row (``t >= lengths[b]``) writes its four
    zero dgates vectors and nothing else; it reads only ``lengths[b]``."""
    vec = BACKWARD_VECTOR_FLOATS
    hv = hidden // vec
    total = directions * batch * hv
    blocks = -(-total // BACKWARD_THREADS)
    work = []
    for at in range(blocks * BACKWARD_THREADS):
        if at >= total:
            work.append([])
            continue
        v, row = at % hv, at // hv
        b, d = row % batch, row // batch
        step = (d * seq_len + t) * batch + b
        dgates = [("dgates_all", "write", (step * 4 * hv + v + k * hv) * vec)
                  for k in range(4)]
        if t >= lengths[b]:
            work.append(dgates)
            continue
        reads = [("gates_all", "read", (step * 4 * hv + v + k * hv) * vec)
                 for k in range(4)]
        reads.append(("c_all", "read", (step * hv + v) * vec))
        if t > 0:
            reads.append(("c_all", "read", ((step - batch) * hv + v) * vec))
        reads += [("dh", "read", at * vec), ("dc", "read", at * vec)]
        work.append(reads + dgates + [("dc", "write", at * vec),
                                      ("dh", "write", at * vec)])
    return work


def _check_backward_step_args(gates_all, c_all, lengths, dh, dc, dgates_all):
    """Raise on anything kernel B does not take; returns ``(D, T, B, H)``."""
    if gates_all.dim() != 4 or gates_all.shape[-1] % 4:
        raise ValueError(f"expected gates_all [D,T,B,4H]; got "
                         f"{tuple(gates_all.shape)}")
    directions, seq_len, batch, four_h = gates_all.shape
    hidden = four_h // 4
    expected = {"c_all": (directions, seq_len, batch, hidden),
                "lengths": (batch,), "dh": (directions, batch, hidden),
                "dc": (directions, batch, hidden),
                "dgates_all": tuple(gates_all.shape)}
    tensors = {"c_all": c_all, "lengths": lengths, "dh": dh, "dc": dc,
               "dgates_all": dgates_all}
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}; got "
                             f"{tuple(tensors[name].shape)}")
    _check_cuda_contiguous(gates_all, gates_all=gates_all, **tensors)
    for name, tensor in (("gates_all", gates_all), *tensors.items()):
        want = torch.int32 if name == "lengths" else torch.float32
        if tensor.dtype != want:
            raise ValueError(f"{name} must be {want}, got {tensor.dtype}")
    return directions, seq_len, batch, hidden


def lstm_backward_step_launcher(
    gates_all: torch.Tensor,   # [D, T, B, 4H] f32
    c_all: torch.Tensor,       # [D, T, B, H] f32
    lengths: torch.Tensor,     # [B] int32
    dh: torch.Tensor,          # [D, B, H] f32, updated in place
    dc: torch.Tensor,          # [D, B, H] f32, updated in place
    dgates_all: torch.Tensor,  # [D, T, B, 4H] f32
) -> Callable[[int], None]:
    """Kernel B for a whole backward: checks the six tensors once, fetches
    the C entry and the stream once, and returns the thin per-step entry
    ``launch(t)``, which only launches reverse step ``t`` (the C entry
    refuses a ``t`` outside ``0 .. T - 1``). The tensors must stay where
    they are until the last launch: ``dh`` is updated in place between two
    steps, not replaced. Its launches count on
    :func:`lstm_backward_step_cuda`."""
    directions, seq_len, batch, hidden = _check_backward_step_args(
        gates_all, c_all, lengths, dh, dc, dgates_all)
    tensors = (gates_all, c_all, lengths, dh, dc, dgates_all)
    vector = backward_step_vector_path(
        directions, batch, hidden,
        tuple(x.data_ptr() for k, x in enumerate(tensors) if k != 2))
    # ctypes objects made once: the per-step call converts only t.
    pointers = tuple(ctypes.c_void_p(x.data_ptr()) for x in tensors)
    sizes = tuple(ctypes.c_int(n)
                  for n in (directions, seq_len, batch, hidden))
    entry = _native.library().vqa_lstm_backward_step
    stream = _native.stream_ptr(gates_all.device)
    counted = 1 if directions * batch * hidden else 0
    wrapper = lstm_backward_step_cuda

    def launch(t: int) -> None:
        code = entry(*pointers, *sizes, t, stream)
        if code:
            _native.check("lstm_backward_step", code)
        wrapper.launches += counted
        if vector:
            wrapper.launches_vector += counted

    return launch


def lstm_backward_step_cuda(
    gates_all: torch.Tensor,   # [D, T, B, 4H] f32
    c_all: torch.Tensor,       # [D, T, B, H] f32
    lengths: torch.Tensor,     # [B] int32
    dh: torch.Tensor,          # [D, B, H] f32, updated in place
    dc: torch.Tensor,          # [D, B, H] f32, updated in place
    dgates_all: torch.Tensor,  # [D, T, B, 4H] f32, step t is written
    t: int,
) -> None:
    """Kernel B, reverse step ``t``: writes ``dgates_all[:, t]``, turns
    ``dc`` into ``dc_prev`` and ``dh`` into the part that passes a padded
    step, ``(1 - keep) * dh``; every check on every call. ``launches``
    counts its grids and the launcher's, ``launches_vector`` those of the
    vector kernel."""
    launch = lstm_backward_step_launcher(gates_all, c_all, lengths, dh, dc,
                                         dgates_all)
    if not 0 <= t < gates_all.shape[1]:
        raise ValueError(f"step {t} is outside 0..{gates_all.shape[1] - 1}")
    launch(t)


lstm_backward_step_cuda.launches = 0
lstm_backward_step_cuda.launches_vector = 0
