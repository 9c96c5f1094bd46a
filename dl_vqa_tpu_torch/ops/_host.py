"""Build and load the package's host libraries (C++, compiled by ``g++``).

The sibling of :mod:`dl_vqa_tpu_torch.ops._native` for code that runs on
the host, not the card:

* ``image``: the port's libjpeg decoder (``csrc/host/image_decode.cc``:
  RGB, greyscale and CMYK JPEGs, one image or a list of files on a pool of
  host threads) and the port's copy of the native resize and centre crop
  (``csrc/host/resample.cc``);
* ``serve``: ``native/serve_front.cc`` and ``native/image_pipeline.cc``,
  unchanged: the native serving front (:mod:`dl_vqa_tpu_torch.utils.
  native_front`);
* ``nvjpeg``: ``csrc/host/nvjpeg_decode.cc`` (the JPEG's planes decoded
  on the card by the CUDA toolkit's nvJPEG) and its two host stages:
  libjpeg's chroma upsampling and colour conversion (``csrc/host/ycc.cc``)
  and the port's copy of the native resize (``csrc/host/resample.cc``);
* ``exact``: the "exact" decoder's host stages, which need no libjpeg:
  the JPEG entropy decoder (``csrc/host/jpeg_entropy.cc``: markers,
  Huffman-coded baseline and progressive scans) and PNG's row filters undone
  (``csrc/host/png_unfilter.cc``).

Each is compiled on first use with the flags of ``native/Makefile``, one
``g++`` a source and all started together, then linked, into
``dl_vqa_tpu_torch/_build/<hash>/``; the hash covers the sources, headers,
flags, compiler and the host's processor (``-march=native``), and the file
is written under a temporary name and renamed into place. ``native/`` is
read, never written. A missing compiler or header raises and names it:
nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

__all__ = ["library", "missing"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG_DIR)
_BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
_HOST = os.path.join(_PKG_DIR, "csrc", "host")
_NATIVE = os.path.join(_REPO, "native")

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_C = ctypes.c_char_p
_LL = ctypes.c_longlong
_I32P = ctypes.POINTER(ctypes.c_int32)


def _cuda_home() -> str:
    if os.environ.get("CUDA_HOME"):
        return os.environ["CUDA_HOME"]
    from dl_vqa_tpu_torch.ops._native import _nvcc

    try:
        return os.path.dirname(os.path.dirname(os.path.realpath(_nvcc())))
    except RuntimeError:
        return "/usr/local/cuda"


# name -> (sources, headers the hash covers, include dirs, headers the
# build needs and what provides them, libraries, {C entry: (argtypes,
# restype)})
def _spec(name: str):
    if name == "image":
        return ((os.path.join(_HOST, "image_decode.cc"),
                 os.path.join(_HOST, "resample.cc")),
                (os.path.join(_HOST, "resample.h"),),
                (_HOST,),
                {"jpeglib.h": "libjpeg's headers (a libjpeg-dev package)"},
                ("-ljpeg", "-lpthread"),
                {"vqa_torch_decode_jpeg": ([_C, ctypes.c_size_t, _I, _D, _P],
                                           _I),
                 "vqa_torch_decode_files": ([_P, _I, _I, _D, _P, _I, _P],
                                            _I)})
    if name == "serve":
        c = ctypes
        return ((os.path.join(_NATIVE, "serve_front.cc"),
                 os.path.join(_NATIVE, "image_pipeline.cc")),
                (os.path.join(_NATIVE, "transform.h"),),
                (_NATIVE,),
                {"jpeglib.h": "libjpeg's headers (a libjpeg-dev package)"},
                ("-ljpeg", "-lpthread"),
                {"vqa_front_start": ([_C, _I, _I, _D, _I, _I, _I, _I, _I, _D,
                                      _I], _I),
                 "vqa_front_port": ([], _I),
                 "vqa_front_generation": ([], _LL),
                 "vqa_front_set_question_vocab": ([_C, _I32P, _I], _I),
                 "vqa_front_set_answers": ([_C, _I], _I),
                 "vqa_front_set_backend": ([_C], _I),
                 "vqa_front_set_gauge": ([_C, _LL], _I),
                 "vqa_front_next_batch": ([_LL, c.POINTER(c.c_uint8), _I32P,
                                           _I32P, _I32P, _I32P, _I], _LL),
                 "vqa_front_complete": ([_LL, _LL, _I32P,
                                         c.POINTER(c.c_float), _I], _I),
                 "vqa_front_fail": ([_LL, _LL, _C], _I),
                 "vqa_front_metrics_json": ([_C, _I], None),
                 "vqa_front_stop": ([], None),
                 "vqa_front_tokenize": ([_C, _I32P, _I], _I)})
    if name == "nvjpeg":
        cuda = _cuda_home()
        return ((os.path.join(_HOST, "nvjpeg_decode.cc"),
                 os.path.join(_HOST, "ycc.cc"),
                 os.path.join(_HOST, "resample.cc")),
                (os.path.join(_HOST, "ycc.h"),
                 os.path.join(_HOST, "resample.h")),
                (_HOST, os.path.join(cuda, "include")),
                {"nvjpeg.h": f"the CUDA toolkit's nvJPEG (CUDA_HOME={cuda})",
                 "cuda_runtime.h": f"the CUDA toolkit (CUDA_HOME={cuda})"},
                (f"-L{os.path.join(cuda, 'lib64')}",
                 f"-Wl,-rpath,{os.path.join(cuda, 'lib64')}",
                 "-lnvjpeg", "-lcudart", "-lpthread"),
                {"vqa_torch_nvjpeg_decode": ([_C, ctypes.c_size_t, _I, _D, _I,
                                             _P], _I),
                 "vqa_torch_nvjpeg_last_error": ([], _C)})
    if name == "exact":
        size = ctypes.c_size_t
        return ((os.path.join(_HOST, "jpeg_entropy.cc"),
                 os.path.join(_HOST, "png_unfilter.cc")),
                (os.path.join(_HOST, "jpeg_entropy.h"),
                 os.path.join(_HOST, "resample.h")),
                (_HOST,), {}, (),
                {"vqa_torch_jpeg_parse": ([_C, size], _P),
                 "vqa_torch_jpeg_status": ([_P, _P, _I], _I),
                 "vqa_torch_jpeg_header": ([_P, _P], _I),
                 "vqa_torch_jpeg_coefficients": ([_P, _I], _P),
                 "vqa_torch_jpeg_qtable": ([_P, _I], _P),
                 "vqa_torch_jpeg_export": ([_P, _P, _P], _I),
                 "vqa_torch_jpeg_free": ([_P], None),
                 "vqa_torch_png_unfilter": ([_C, size, _I, size, _I, _P],
                                            _I)})
    raise ValueError(f"unknown host library {name!r}")


_locks: Dict[str, threading.Lock] = {
    name: threading.Lock()
    for name in ("image", "serve", "nvjpeg", "exact")}
_libs: Dict[str, ctypes.CDLL] = {}


def _cxx() -> Tuple[Optional[str], str]:
    """(path of the compiler or None, the name asked for: $CXX or g++)."""
    name = os.environ.get("CXX") or "g++"
    return shutil.which(name), name


def _machine_key() -> bytes:
    """What ``-march=native`` compiles for: the processor's model and
    flags (a library built on another host may not run here)."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as fd:
            for line in fd:
                if line.startswith(("model name", "flags")):
                    key += line
                if line.strip() == "":
                    break
    except OSError:
        pass
    return key.encode()


def missing(name: str) -> Optional[str]:
    """Why library ``name`` cannot be built here (the compiler or a header
    it needs is missing), or None."""
    cxx, asked = _cxx()
    if cxx is None:
        return (f"{asked} not found (set CXX or put g++ on PATH): the host "
                "libraries of dl_vqa_tpu_torch are compiled on first use")
    _, _, includes, needs, _, _ = _spec(name)
    for header, provider in needs.items():
        proc = subprocess.run(
            [cxx, "-std=c++17", "-E", "-x", "c++", "-o", os.devnull,
             *(f"-I{d}" for d in includes), "-"],
            input=f"#include <{header}>\n", capture_output=True, text=True,
            timeout=60)
        if proc.returncode != 0:
            return (f"{header} not found: building libvqa_torch_{name}.so "
                    f"needs {provider}")
    return None


def _build(name: str) -> str:
    sources, headers, includes, _, libs, _ = _spec(name)
    cxx, _ = _cxx()
    reason = missing(name)
    if reason is not None:
        raise RuntimeError(reason)
    digest = hashlib.sha256(" ".join((cxx, *CXX_FLAGS, *libs)).encode())
    digest.update(_machine_key())
    for path in sources + headers:
        with open(path, "rb") as fd:
            digest.update(os.path.basename(path).encode())
            digest.update(fd.read())
    out_dir = os.path.join(_BUILD_ROOT, digest.hexdigest()[:16])
    target = os.path.join(out_dir, f"libvqa_torch_{name}.so")
    if os.path.exists(target):
        return target
    os.makedirs(out_dir, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    inc = [f"-I{d}" for d in includes]
    jobs = []
    for source in sources:
        obj = os.path.join(out_dir, f"{os.path.basename(source)}.{tag}.o")
        cmd = [cxx, *CXX_FLAGS, *inc, "-c", source, "-o", obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                            f"{out}\n{err}")
    objects = [obj for _, obj, _ in jobs]
    try:
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = f"{target}.{tag}"
        cmd = [cxx, "-shared", "-o", tmp, *objects, *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    return target


def library(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``image``, ``serve``, ``nvjpeg``
    or ``exact``), built on first call; raises where it cannot be built."""
    if name not in _locks:
        raise ValueError(f"unknown host library {name!r}")
    with _locks[name]:
        if name not in _libs:
            lib = ctypes.CDLL(_build(name))
            for entry, (argtypes, restype) in _spec(name)[5].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
        return _libs[name]
