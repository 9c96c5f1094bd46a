"""What the compare tools share: several source trees of a kernel built
side by side by ``nvcc -Xptxas -v``, SASS instruction counts, and
CUDA-event timing."""

from __future__ import annotations

import ctypes
import os
import re
import subprocess

import torch

from dl_vqa_tpu_torch.ops import _native

CSRC = _native._CSRC  # the shared headers


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, and
    its SM count."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return f"{smi}, {sms} SMs"


def build(versions: dict, sources: tuple, out_dir: str) -> dict:
    """name -> ``ctypes.CDLL`` of the files ``sources`` from each version's
    directory (``versions`` maps a name to it), one ``nvcc`` each, all
    started together. Prints each kernel's registers and spills."""
    jobs = {}
    for name, src in versions.items():
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-Xptxas",
               "-v", "-I", CSRC, "-o", f"{out_dir}/{name}.so",
               *(f"{src}/{file}" for file in sources)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                info = "; ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "Used" in x or "spill" in x)
                print(f"{name} {line.split(chr(39))[1][:72]}: {info}")
        libs[name] = ctypes.CDLL(f"{out_dir}/{name}.so")
    return libs


def sass_counts(library: str, opcode: str) -> dict:
    """Kernel (mangled name) -> how many ``opcode`` instructions its SASS
    holds, by ``cuobjdump -sass`` from the toolkit beside ``nvcc``."""
    cuobjdump = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                         text=True, check=True).stdout
    counts, kernel = {}, None
    for line in out.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            kernel = found.group(1)
            counts[kernel] = 0
        elif kernel and re.search(rf"\b{opcode}\b", line):
            counts[kernel] += 1
    return counts


def timed(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after three, by CUDA
    events."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
