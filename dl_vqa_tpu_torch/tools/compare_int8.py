#!/usr/bin/env python3
"""Time kernel D (the W8A8 conv block of the int8 serving mode,
csrc/conv_relu_pool_int8.cu) of several source trees in turns on one card,
and hold each to the plain version's codes.

    python3 -m dl_vqa_tpu_torch.tools.compare_int8 [--batches=1,8,64,512] \
        NAME=DIR [...]

Each DIR holds a version of ``conv_relu_pool_int8.cu`` (for instance
``dl_vqa_tpu_torch/csrc``, or an older commit's file taken with ``git
show <rev>:dl_vqa_tpu_torch/csrc/conv_relu_pool_int8.cu`` into a
directory that ``.gitignore`` lists); the shared headers come from
``dl_vqa_tpu_torch/csrc``. Every version is compiled by ``nvcc -Xptxas
-v`` (the tool prints each kernel's registers and spills and its count of
``IGMMA`` (s8 wgmma) and ``IMMA`` (s8 mma.sync) instructions). A version
whose C entry takes the plan (``int kind``) gets
``ops/conv_int8.py::w8a8_plan`` and the weights that plan's kernel takes;
an older one the mma.sync fragments (``pack_int8_weight``). At the reference model's conv1 (111 px, 64 -> 128)
and conv2 (54 px, 128 -> 256) for B = 1, 8, 64 and 512 (or the batches
given), on the same
random int8 inputs, it checks that each version's codes equal the plain
version's, then times the versions by CUDA events in the order given and
back, the weights quantized and packed beforehand, with in the same turns
the bf16 block the int8 mode replaces (``conv_nhwc`` + kernel 2, built
from this tree) and this tree's whole wrapper
(``conv_relu_pool_w8a8_cuda``: quantizing and packing the weights on every
call). Each time is printed with its TOP/s and its share of the bound
(operations at the 1,979 TOP/s int8 peak, or bytes at 3.35 TB/s). Run from
the repository root on a machine with an NVIDIA GPU and nvcc; imports no
JAX.
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch

from dl_vqa_tpu_torch.ops import _native, conv_fused, conv_int8
from dl_vqa_tpu_torch.tools._compare import build, card, sass_counts, timed

SOURCES = ("conv_relu_pool_int8.cu",)
CONVS = ((111, 64, 128), (54, 128, 256))  # input size, Cin, Cout; k = 3
BATCHES = (1, 8, 64, 512)
PEAK_INT8 = 1979e12
HBM_BYTES_PER_S = 3.35e12
S_IN = 3.0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load(versions: dict, out_dir: str) -> dict:
    """name -> (library, its entry takes the plan)."""
    libs = {}
    for name, lib in build(versions, SOURCES, out_dir).items():
        with open(f"{versions[name]}/conv_relu_pool_int8.cu") as fd:
            planned = "int kind" in fd.read()
        lib.vqa_conv_relu_pool_int8.argtypes = (
            _native._SIGNATURES["vqa_conv_relu_pool_int8"] if planned
            else [_P] * 5 + [_I] * 7 + [_F, _P])
        for op in ("IGMMA", "IMMA"):
            for kernel, count in sass_counts(f"{out_dir}/{name}.so",
                                             op).items():
                print(f"{name} ...{kernel[-48:]}: {count} {op}")
        libs[name] = (lib, planned)
    return libs


def main(argv) -> int:
    batches = BATCHES
    if argv and argv[0].startswith("--batches="):
        batches = tuple(int(b) for b in argv[0].split("=", 1)[1].split(","))
        argv = argv[1:]
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    versions = dict(arg.split("=", 1) for arg in argv)
    names = list(versions)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as out_dir:
        libs = load(versions, out_dir)
        print(card())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for size, cin, cout in CONVS:
            w = torch.randn(cout, cin, 3, 3, generator=gen,
                            device="cuda") * 0.05
            b = torch.randn(cout, generator=gen, device="cuda") * 0.1
            w_q, mult = conv_int8._epilogue_scales(w, S_IN)
            plan = conv_int8.w8a8_plan(size, size, cin, cout, 3, 1, sms)
            print(f"conv {size} px {cin} -> {cout}: {plan}")
            packed = {
                True: (conv_int8.pack_int8_weight_wgmma(w_q, plan)
                       if plan.kernel == "wgmma"
                       else conv_int8.pack_int8_weight(w_q)),
                False: conv_int8.pack_int8_weight(w_q)}
            for batch in batches:
                x = torch.randint(0, 128, (batch, size, size, cin),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8)
                # s_out: the amax of the block's post-ReLU output on two
                # images, so that the codes spread over [0, 127].
                probe = conv_int8._integer_conv(x[:2], w_q, 1).float() * \
                    mult + b
                s_out = float(probe.clamp(min=0).amax())
                scale = conv_int8.f32(127.0 / s_out)
                hp = (size - 2) // 2
                out = torch.empty(batch, hp, hp, cout, dtype=torch.int8,
                                  device="cuda")

                def call(name):
                    lib, planned = libs[name]
                    tail = list(plan.c_args()) if planned else []
                    wk = packed[planned]

                    def run():
                        code = lib.vqa_conv_relu_pool_int8(
                            x.data_ptr(), wk.data_ptr(), mult.data_ptr(),
                            b.data_ptr(), out.data_ptr(), batch, size, size,
                            cin, cout, 3, 1, scale, *tail, stream)
                        assert code == 0, f"{name}: CUDA error {code}"
                        return out
                    return run

                runs = {n: call(n) for n in names}
                xb = x.to(torch.bfloat16)
                runs["bf16 block"] = lambda: conv_fused.relu_maxpool_cuda(
                    conv_fused.conv_nhwc(xb, w), b)
                runs["wrapper"] = lambda: conv_int8.conv_relu_pool_w8a8_cuda(
                    x, S_IN, w, b, 1, s_out)
                want = conv_int8.conv_relu_pool_w8a8_reference(
                    x, S_IN, w, b, 1, s_out)
                for n in names + ["wrapper"]:
                    got = runs[n]()
                    torch.cuda.synchronize()
                    diff = int((got.int() - want.int()).abs().max())
                    print(f"conv {size} px B = {batch} {n}: max code "
                          f"difference {diff}, "
                          f"{float((want > 0).float().mean()):.3f} of the "
                          "codes above 0")
                del want, probe
                ops = 2.0 * batch * (2 * hp) ** 2 * cout * 9 * cin
                moved = x.numel() + w_q.numel() + out.numel()
                bound = max(ops / PEAK_INT8, moved / HBM_BYTES_PER_S) * 1e3
                iters = 20 if batch >= 64 else 200
                order = list(runs)
                times = {n: [] for n in order}
                for n in order + order[::-1]:
                    times[n].append(timed(runs[n], iters))
                for n in order:
                    ms = sum(times[n]) / len(times[n])
                    print(f"conv {size} px B = {batch} {n}: {ms:.4f} ms "
                          f"({', '.join(f'{t:.4f}' for t in times[n])}) = "
                          f"{ops / ms / 1e9:.1f} TOP/s, {bound / ms:.1%} of "
                          f"the {bound:.4f} ms bound")
                del x, xb, out
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
