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
    started together. Prints each kernel's registers and spills, and any
    performance advisory of ptxas (wgmma serialized, for instance)."""
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
        for line in lines:
            if "Performance Loss" in line:
                print(f"{name} {line.strip()}")
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


def color_resample_work(plan, components) -> tuple:
    """``(bytes, integer operations)`` of ``color_resample``'s function on
    one image, whatever implements it: each component's samples that the
    input rectangle of the crop's taps reaches (``pixel // expansion``, one
    sample of halo each side, clamped; an RGB8 source's rectangle where
    ``components`` is None), the taps and the output; the colour, 40
    operations a pixel of the rectangle (two upsampled chroma samples and
    the conversion), and Pillow's two passes as the function needs them, 3
    channels each: the horizontal pass once for each input row the
    vertical taps read (a multiply-add a tap, then the rounding and clip
    of each output column), then the vertical pass (a multiply-add a tap
    and the rounding and clip of each output pixel)."""
    size = plan.size
    xt = plan.taps[:size * (2 + plan.kx)].reshape(size, -1)
    yt = plan.taps[size * (2 + plan.kx):].reshape(size, -1)

    def span(t):
        return int((t[:, 0] + t[:, 1]).max() - t[:, 0].min())

    def extent(t, expand, real):
        lo = max(int(t[:, 0].min()) // expand - 1, 0)
        hi = min((int((t[:, 0] + t[:, 1]).max()) - 1) // expand + 1,
                 real - 1)
        return hi - lo + 1

    if components is None:
        samples = 3 * span(xt) * span(yt)
    else:
        samples = sum(extent(xt, c.max_h // c.h, c.width)
                      * extent(yt, c.max_v // c.v, c.height)
                      for c in components)
    moved = samples + plan.taps.nbytes + size * size * 3
    ops = (40 * span(xt) * span(yt)
           + 3 * (span(yt) * (2 * int(xt[:, 1].sum()) + 3 * size)
                  + size * (2 * int(yt[:, 1].sum()) + 3 * size)))
    return moved, ops
