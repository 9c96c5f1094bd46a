"""Build and load the package's hand-written CUDA kernels.

The sources in ``dl_vqa_tpu_torch/csrc/*.cu`` have a plain C interface.
On first use they are compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source and all started together, linked into one
shared library and loaded with ``ctypes``; nothing here runs at import.
The library lands in ``dl_vqa_tpu_torch/_build/<hash>/``, keyed
by a hash of the sources and flags, and is written under a temporary
name and renamed into place, so concurrent first uses cannot load a
half-written file.

Every C entry takes its pointers and the CUDA stream as ``c_void_p``
(declared on ``argtypes``, or ctypes would cut them to 32 bits) and
returns ``cudaGetLastError()`` of its launches; :func:`check` raises on
a nonzero code.

The kernels of the serving forward are also ``torch.library`` custom ops
in the ``vqa`` namespace (:func:`define_op`), so that ``torch.export``
and PyTorch's other graph tools see each launch as one node: a ctypes
call on ``data_ptr()`` cannot be traced.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Optional

__all__ = ["library", "check", "stream_ptr", "sm_count", "build_seconds",
           "define_op", "NVCC_FLAGS"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_LIB_NAME = "libvqa_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argument types; every entry returns an int (cudaError_t unless
# noted).
_SIGNATURES = {
    # xproj, whh, lengths, h_a, h_b, hq_a, hq_b, c, directions, seq_len,
    # batch, hidden, dtype code, stream
    "vqa_lstm_recurrence": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P],
    # as above, with gates_all, c_all, h_all after c
    "vqa_lstm_recurrence_save": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P],
    # xproj, whh, lengths, h, c, hq, barrier, gates_all, c_all, h_all (the
    # last three null unless save), directions, seq_len, batch, hidden,
    # units, shared-memory bytes, save, stream
    "vqa_lstm_recurrence_persistent": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # xproj, whh, lengths, order, live (both null in mode 1), h, c, hbuf,
    # barrier, gates_all, c_all (null but in mode 1), h_all (null in mode
    # 0), directions, seq_len, batch, hidden, shared-memory bytes, mode (0
    # final state, 1 save, 2 token states), stream
    "vqa_lstm_recurrence_f32": [_P] * 12 + [_I] * 6 + [_P],
    # gates_all, c_all, lengths, dh, dc, dgates_all, directions, seq_len,
    # batch, hidden, t, stream
    "vqa_lstm_backward_step": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P],
    # gates_all, c_all, dh, dc, dgates_all, directions, batch, hidden -> 1
    # where the call runs kernel B's vector kernel, else 0 (not an error)
    "vqa_lstm_backward_step_vector": [_P, _P, _P, _P, _P, _I, _I, _I],
    # y, bias, out, batch, hc, wc, channels, dtype code, output mode (0
    # compute, 1 e4m3, 2 int8), the int8 mode's scale, stream
    "vqa_relu_maxpool": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, packed weights, mult, bias, out, batch, h, w, cin, cout, k,
    # stride, scale, then the plan's c_args (ops/conv_int8.py::w8a8_plan:
    # kernel, warp rows, warp columns, channels, ck, tiles down, tiles
    # across, atoms, stage bytes, pixel bytes, blocks a slice, shared
    # bytes), stream
    "vqa_conv_relu_pool_int8": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 12
                               + [_P],
    # g, y, bias, dz, batch, hc, wc, channels, dtype code -> 1 where the
    # call runs the vector kernel, else 0 (not an error)
    "vqa_relu_maxpool_backward_vector": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    # as above -> the number of blocks (rows of `partial`), not an error
    "vqa_relu_maxpool_backward_blocks": [_P, _P, _P, _P, _I, _I, _I, _I, _I],
    # g, y, bias, dz, db, partial, batch, hc, wc, channels, dtype code,
    # stream
    "vqa_relu_maxpool_backward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P],
    # v, att, out, batch, spatial, channels, glimpses, dtype code, stream
    "vqa_attention_pool": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # qkv, out, batch, seq, heads, head size, 1 / sqrt(head), the device's
    # SM count, dtype code, the plan's c_args
    # (ops/vit_attention.py::attention_plan: design, rows, key tile, stages,
    # shared bytes of kernel 4 and of kernel 5's two grids, statistics row
    # length), stream
    "vqa_vit_attention": [_P, _P, _I, _I, _I, _I, _F, _I, _I] + [_I] * 8
                         + [_P],
    # qkv, g, dqkv, stats (f32 scratch [B, H, 3, stats_len] of the two-grid
    # paths; null for bf16 heads of 64 up to 256 tokens), batch, seq, heads,
    # head size, 1 / sqrt(head), dtype code, the plan's c_args, stream
    "vqa_vit_attention_backward": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I]
                                  + [_I] * 8 + [_P],
    # x, w [k * k, Cin, Cout], bias, out, batch, h, w, cin, cout, k, dtype
    # code, stream
    "vqa_conv_relu_pool_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P],
    # h, w, cin, cout, k, int[5] -> kernel 6's bf16 plan (warp rows, warp
    # columns, channels a block, input channels a stage, shared bytes)
    "vqa_conv_relu_pool_fused_plan": [_I, _I, _I, _I, _I, _P],
    # cin, cout, k, dtype code -> 1 where kernel 7 runs on the tensor cores
    # (w packed by conv_fused.pack_stem_weight), else 0 (not an error)
    "vqa_conv_relu_pool_stem_mma": [_I, _I, _I, _I],
    # as kernel 6's, with w packed for the tensor cores or f32 [k, k, Cin,
    # Cout] as the entry above says
    "vqa_conv_relu_pool_stem": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P],
    # x, ln scale, ln bias, w1, b1, w2, b2, out, packed-weight scratch
    # (bf16), rows, dim, hidden, warpgroups a block (bf16), dtype code,
    # stream
    "vqa_vit_mlp_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P],
    # int64 descriptors [n, 7] (x, out, rows, width, channels, mode, dtype
    # code), n (1 to 8), stream: the n cases in one launch
    "vqa_layout_cases": [_P, _I, _P],
    # Kernel E: four coefficient arrays, four int16 tables, four planes
    # (null beyond ncomp), four blocks_w, four blocks_h, ncomp, stream
    "vqa_exact_idct": [_P] * 12 + [_I] * 9 + [_P],
    # Kernels F and G as one (color_resample): int64 image descriptors and
    # int32 tile plan on the card (ops/exact_decode.py::tile_plan), tiles,
    # shared bytes, stream
    "vqa_color_resample": [_P, _P, _I, _I, _P],
    # The exact decoder's device stages for a chunk, E and color_resample
    # through their entries: int64 descriptor (csrc/exact_pipeline.cu),
    # stream
    "vqa_exact_decode_batch": [_P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None


def _sources():
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install prefix; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of dl_vqa_tpu_torch are compiled on first use")


def _build() -> str:
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as fd:
            digest.update(os.path.basename(path).encode())
            digest.update(fd.read())
    out_dir = os.path.join(_BUILD_ROOT, digest.hexdigest()[:16])
    target = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(target):
        return target
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp{os.getpid()}"
    # One compiler process per source, all running at once, then one link.
    jobs = []
    for source in sources:
        if source.endswith(".cu"):
            obj = os.path.join(
                out_dir, f"{os.path.basename(source)[:-3]}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", source, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    failures = []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{out}\n{err}")
    objects = [obj for _, obj, _ in jobs]
    try:
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = f"{target}.{tag}"
        cmd = [nvcc, "-shared", "-o", tmp, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _build_seconds
    with _lock:
        if _lib is None:
            start = time.perf_counter()
            lib = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vqa_error_string.argtypes = [ctypes.c_int]
            lib.vqa_error_string.restype = ctypes.c_char_p
            _build_seconds = time.perf_counter() - start
            _lib = lib
        return _lib


def build_seconds() -> Optional[float]:
    """Seconds the first :func:`library` call took (build and load)."""
    return _build_seconds


def check(name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        text = library().vqa_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({text}) at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (a persistent grid's size)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def define_op(name: str, schema: str, plain: Callable, cuda: Callable,
              fake: Callable):
    """Register the custom op ``vqa::<name>`` with ``schema`` (its
    arguments and returns, e.g. ``"(Tensor v, Tensor att) -> Tensor"``):
    ``plain``, the kernel's plain PyTorch version, runs it on CPU tensors,
    ``cuda``, the kernel's wrapper (which counts its launches and raises
    where the kernel cannot launch), on CUDA tensors, and ``fake`` gives
    each output's shape, dtype and layout to a tracer. No other device has
    an implementation. Returns the op (``torch.ops.vqa.<name>``)."""
    import torch

    op = torch.library.custom_op(f"vqa::{name}", plain, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    return op
