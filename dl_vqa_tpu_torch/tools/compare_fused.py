#!/usr/bin/env python3
"""Time kernels 8 (the fused LN + MLP, csrc/vit_mlp_fused.cu), 6 (the
fused conv + ReLU + pool, csrc/conv_relu_pool_fused.cu), C (the bias +
ReLU + pool backward, csrc/relu_maxpool_backward.cu) and 7 (the RGB stem,
csrc/conv_relu_pool_stem.cu) of several source trees in turns on one card,
and hold each to the plain versions.

    python3 -m dl_vqa_tpu_torch.tools.compare_fused [--kernels=8,6,C,7] \
        NAME=DIR [...]

``--kernels`` picks the kernels to time (all four by default). Each DIR
holds a version of the four files (for instance
``dl_vqa_tpu_torch/csrc``, or the files of an older commit taken with
``git show``); the shared headers come from ``dl_vqa_tpu_torch/csrc``.
Every version is compiled by ``nvcc -Xptxas -v``; the tool prints each
kernel's registers and spills, the count of ``HGMMA`` (wgmma) instructions
in its SASS (``cuobjdump -sass``), and the dynamic shared memory of this
tree's plans. A version whose kernel 8 entry takes ``warpgroups`` gets
this tree's row plan and packing scratch, and one with
``vqa_conv_relu_pool_fused_plan`` this tree's packed conv weight; an older
one gets the plain layouts it took. At B = 1, 8 and 512, bf16, on the
same inputs (kernel 8: S = 196, D = 256, F = 1024; kernel 6: the model's
conv1 and conv2, and conv2's size at 384 input channels, whose weights
this tree streams), it prints each version's largest difference from the
plain version, the share of elements that differ, and whether its bits
equal the first version's; then the kernels' times by CUDA events in the
order given and back, the weights cast beforehand (a kernel 8 with a
packing scratch packs them in each call), with the yardsticks
timed in the same turns: the library chain for kernel 8, and for kernel 6
both the three-call chain (``F.conv2d`` + ``F.relu`` + ``F.max_pool2d``,
channels_last) and the unfused block (``conv_nhwc`` + kernel 2, built from
this tree). Kernel C runs at the model's three conv outputs at B = 512 in
bf16 on tied values (dz to the plain version's bits, db within 1e-5 of the
sum of |g|), beside a copy of the same conv output (``dst.copy_(y)``), with
each time's GB/s; kernel 7 at the stem's shape (224 x 224 x 3 -> 64, k = 3)
at B = 1, 8 and 512 in bf16 beside the three-call chain. A version with
``vqa_relu_maxpool_backward_vector`` gets the tree's block count entry, and
one with ``vqa_conv_relu_pool_stem_mma`` the weights packed by
``conv_fused.pack_stem_weight`` where that entry says so; an older one the
layouts it took. Run from the repository root (DIRs are taken from there)
on a machine with an NVIDIA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import re
import sys
import tempfile

import torch
import torch.nn.functional as F

from dl_vqa_tpu_torch.ops import conv_fused, vit_mlp_fused
from dl_vqa_tpu_torch.tools._compare import build, card, sass_counts, timed

SOURCES = ("vit_mlp_fused.cu", "conv_relu_pool_fused.cu",
           "relu_maxpool_backward.cu", "conv_relu_pool_stem.cu")
TOKENS, WIDTH, HIDDEN = 196, 256, 1024
CONVS = ((111, 64, 128), (54, 128, 256))  # input size, Cin, Cout; k = 3
STREAMED = ((54, 384, 256),)  # weights no block holds: streamed by the tree
BATCHES = (1, 8, 512)
CONV_OUTPUTS = ((222, 64), (109, 128), (52, 256))  # kernel C: Hc = Wc, C
STEM = (224, 3, 64, 3)  # kernel 7: input size, Cin, Cout, k
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
_P, _I = ctypes.c_void_p, ctypes.c_int


def load(versions: dict, out_dir: str) -> dict:
    """name -> (library, kernel 8 takes a row plan, kernel 6 takes packed
    weights). Prints each kernel's HGMMA count."""
    libs = {}
    for name, lib in build(versions, SOURCES, out_dir).items():
        with open(f"{versions[name]}/vit_mlp_fused.cu") as fd:
            planned = bool(re.search(r"vqa_vit_mlp_fused\([^)]*warpgroups",
                                     fd.read()))
        lib.vqa_vit_mlp_fused.argtypes = (
            [_P] * 9 + [_I] * 5 if planned else [_P] * 8 + [_I] * 4) + [_P]
        lib.vqa_conv_relu_pool_fused.argtypes = [_P] * 4 + [_I] * 7 + [_P]
        lib.vqa_conv_relu_pool_stem.argtypes = [_P] * 4 + [_I] * 7 + [_P]
        lib.vqa_relu_maxpool_backward.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        if hasattr(lib, "vqa_relu_maxpool_backward_vector"):
            lib.vqa_relu_maxpool_backward_blocks.argtypes = [_P] * 4 + [_I] * 5
        else:
            lib.vqa_relu_maxpool_backward_blocks.argtypes = [_I] * 2
        if hasattr(lib, "vqa_conv_relu_pool_stem_mma"):
            lib.vqa_conv_relu_pool_stem_mma.argtypes = [_I] * 4
        packed = hasattr(lib, "vqa_conv_relu_pool_fused_plan")
        for kernel, count in sass_counts(f"{out_dir}/{name}.so",
                                         "HGMMA").items():
            print(f"{name} {kernel[:72]}: {count} HGMMA")
        libs[name] = (lib, planned, packed)
    return libs


def main(argv) -> int:
    picked = {"8", "6", "C", "7"}
    if argv and argv[0].startswith("--kernels="):
        picked = set(argv[0].split("=", 1)[1].split(","))
        argv = argv[1:]
    if not argv or not torch.cuda.is_available() or not picked <= {
            "8", "6", "C", "7"}:
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    versions = dict(arg.split("=", 1) for arg in argv)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = list(versions)
    with tempfile.TemporaryDirectory() as out_dir:
        libs = load(versions, out_dir)
        print(card())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def mlp_inputs(batch):
            def uniform(*shape, fan_in):
                return (torch.rand(*shape, generator=gen, device="cuda") * 2
                        - 1) / fan_in ** 0.5
            x = torch.randn(batch, TOKENS, WIDTH, generator=gen,
                            device="cuda").bfloat16()
            return (x, 1 + 0.1 * torch.randn(WIDTH, generator=gen,
                                             device="cuda"),
                    0.1 * torch.randn(WIDTH, generator=gen, device="cuda"),
                    uniform(HIDDEN, WIDTH, fan_in=WIDTH),
                    uniform(HIDDEN, fan_in=WIDTH),
                    uniform(WIDTH, HIDDEN, fan_in=HIDDEN),
                    uniform(WIDTH, fan_in=HIDDEN))

        def mlp_call(name, args):
            lib, planned, _ = libs[name]
            x, scale, shift, w1, b1, w2, b2 = args
            rows = x.numel() // WIDTH
            w1b, w2b = w1.bfloat16().contiguous(), w2.bfloat16().contiguous()
            out = torch.empty_like(x)
            # The packing scratch lives as long as `run`, which refers to it.
            packed = (torch.empty(2, HIDDEN * WIDTH, dtype=x.dtype,
                                  device="cuda") if planned else None)
            tail = ([vit_mlp_fused.row_plan(rows, sms)[0]] if planned
                    else []) + [1, stream]

            def run():
                head = [] if packed is None else [packed.data_ptr()]
                code = lib.vqa_vit_mlp_fused(
                    x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                    w1b.data_ptr(), b1.data_ptr(), w2b.data_ptr(),
                    b2.data_ptr(), out.data_ptr(), *head, rows, WIDTH,
                    HIDDEN, *tail)
                assert code == 0, f"{name} kernel 8: CUDA error {code}"
                return out
            return run

        def conv_inputs(batch, size, cin, cout):
            x = torch.randn(batch, size, size, cin, generator=gen,
                            device="cuda").bfloat16()
            limit = 1.0 / (cin * 9) ** 0.5
            w = (torch.rand(cout, cin, 3, 3, generator=gen, device="cuda")
                 * 2 - 1) * limit
            b = (torch.rand(cout, generator=gen, device="cuda") * 2 - 1
                 ) * limit
            return x, w, b

        def conv_call(name, args):
            lib, _, packed = libs[name]
            x, w, b = args
            wb = w.bfloat16()
            wk = (conv_fused.pack_conv_weight(wb) if packed
                  else wb.permute(2, 3, 1, 0).contiguous())
            cout = w.shape[0]
            out = torch.empty(x.shape[0], (x.shape[1] - 2) // 2,
                              (x.shape[2] - 2) // 2, cout,
                              dtype=x.dtype, device="cuda")

            def run():
                code = lib.vqa_conv_relu_pool_fused(
                    x.data_ptr(), wk.data_ptr(), b.data_ptr(),
                    out.data_ptr(), x.shape[0], x.shape[1], x.shape[2],
                    x.shape[3], cout, 3, 1, stream)
                assert code == 0, f"{name} kernel 6: CUDA error {code}"
                return out
            return run

        def stem_call(name, x, w, b, out):
            lib = libs[name][0]
            wk = stem_weights(lib, w)

            def run():
                code = lib.vqa_conv_relu_pool_stem(
                    x.data_ptr(), wk.data_ptr(), b.data_ptr(),
                    out.data_ptr(), x.shape[0], x.shape[1], x.shape[2],
                    x.shape[3], out.shape[3], STEM[3], 1, stream)
                assert code == 0, f"{name} kernel 7: CUDA error {code}"
                return out
            return run

        def report(what, batch, runs, want, yardsticks, ops, iters,
                   moved=None):
            got = {}
            for n in names:  # a fault is named after the version at fault
                got[n] = runs[n]().clone()
                try:
                    torch.cuda.synchronize()
                except RuntimeError as err:
                    raise SystemExit(f"B={batch} {what} {n}: {err}")
            for n in names:
                err = float((got[n].float() - want.float()).abs().max())
                print(f"B={batch} {what} {n}: max_abs_err {err:.3e}, "
                      f"{float((got[n] != want).float().mean()):.4%} differ, "
                      f"bits of {names[0]} "
                      f"{torch.equal(got[n], got[names[0]])}")
            order = names + list(yardsticks)
            ms = dict.fromkeys(order, 0.0)
            for n in order + order[::-1]:
                fn = runs[n] if n in runs else yardsticks[n]
                ms[n] += timed(fn, iters) / 2
            least = (f"{ops / PEAK_BF16 * 1e3:.4f} by operations"
                     if moved is None else
                     f"{moved / HBM_BYTES_PER_S * 1e3:.4f} by bytes")
            print(f"B={batch} {what} ms (bound {least}): " + ", ".join(
                f"{n} {v:.4f}" for n, v in ms.items()))
            return ms

        plan_note = ", ".join(
            f"B={b}: {vit_mlp_fused.row_plan(b * TOKENS, sms)}"
            for b in BATCHES)
        print(f"kernel 8 row plans (warpgroups, rows a block, blocks), "
              f"{sms} SMs: {plan_note}; shared bytes 1 warpgroup "
              f"{WIDTH * 64 * 2 + 4 * WIDTH * 128 + 1024}, 2 warpgroups "
              f"{2 * WIDTH * 64 * 2 + 4 * WIDTH * 128 + 1024}")
        for size, cin, cout in CONVS + STREAMED:
            print(f"kernel 6 plan at {size}, {cin} -> {cout}: "
                  f"{conv_fused.fused_plan(size, size, cin, cout, 3)}")
        for batch in BATCHES:
            iters = 20 if batch == 512 else 200
            if "8" in picked:
                args = mlp_inputs(batch)
                x, scale, shift, w1, b1, w2, b2 = args
                lib_args = (scale.bfloat16(), shift.bfloat16(),
                            w1.bfloat16(), b1.bfloat16(), w2.bfloat16(),
                            b2.bfloat16())

                def chain():
                    s_, t_, v1, c1, v2, c2 = lib_args
                    ln = F.layer_norm(x, (WIDTH,), s_, t_, 1e-5)
                    return x + F.linear(F.relu(F.linear(ln, v1, c1)), v2, c2)

                report("kernel 8", batch,
                       {n: mlp_call(n, args) for n in names},
                       vit_mlp_fused.fused_ln_mlp_reference(*args),
                       {"library chain": chain},
                       4.0 * batch * TOKENS * WIDTH * HIDDEN, iters)
                del args, x, lib_args
            for size, cin, cout in (CONVS + STREAMED if "6" in picked
                                    else ()):
                args = conv_inputs(batch, size, cin, cout)
                x, w, b = args
                x_nchw = x.permute(0, 3, 1, 2)
                w_lib = w.bfloat16().contiguous(
                    memory_format=torch.channels_last)
                b_lib = b.bfloat16()
                yardsticks = {
                    "F.conv2d chain": lambda: F.max_pool2d(
                        F.relu(F.conv2d(x_nchw, w_lib, b_lib)), 2),
                    "unfused (conv_nhwc + kernel 2)": lambda:
                        conv_fused.relu_maxpool_cuda(
                            conv_fused.conv_nhwc(x, w), b),
                }
                pooled = ((size - 2) // 2) ** 2
                report(f"kernel 6 {size}x{size}x{cin}->{cout}", batch,
                       {n: conv_call(n, args) for n in names},
                       conv_fused.conv_relu_pool_fused_reference(*args),
                       yardsticks, 2.0 * batch * pooled * 4 * 9 * cin * cout,
                       5 if batch == 512 else 50)
                del args, x, x_nchw
            if "7" in picked:
                size, cin, cout, k = STEM
                x, w, b = conv_inputs(batch, size, cin, cout)
                out = stem_out(x, cout, k)
                x_nchw = x.permute(0, 3, 1, 2)
                w_lib = w.bfloat16().contiguous(
                    memory_format=torch.channels_last)
                b_lib = b.bfloat16()
                report(f"kernel 7 {size}x{size}x{cin}->{cout}", batch,
                       {n: stem_call(n, x, w, b, out) for n in names},
                       conv_fused.conv_relu_pool_stem_reference(x, w, b),
                       {"F.conv2d chain": lambda: F.max_pool2d(
                           F.relu(F.conv2d(x_nchw, w_lib, b_lib)), 2)},
                       2.0 * out.numel() * 4 * k * k * cin,
                       10 if batch == 512 else 100,
                       moved=(x.numel() + out.numel() + w.numel()) * 2
                       + b.numel() * 4)
                del x, x_nchw, out
        if "C" in picked:
            pool_backward(names, libs, stream, gen)
    return 0


def stem_out(x, cout, k):
    return torch.empty(x.shape[0], (x.shape[1] - k + 1) // 2,
                       (x.shape[2] - k + 1) // 2, cout, dtype=x.dtype,
                       device=x.device)


def stem_weights(lib, w):
    """The weight operand a version's kernel 7 takes in bf16."""
    cout, cin, k, _ = w.shape
    if (hasattr(lib, "vqa_conv_relu_pool_stem_mma")
            and lib.vqa_conv_relu_pool_stem_mma(cin, cout, k, 1)):
        return conv_fused.pack_stem_weight(w)
    return w.bfloat16().float().permute(2, 3, 1, 0).contiguous()


def pool_backward(names, libs, stream, gen):
    """Kernel C of each version at the model's three conv outputs, B =
    512, bf16, tied values; a copy of each conv output as the yardstick."""
    total = dict.fromkeys(names + ["copy"], 0.0)
    moved_total = copied_total = 0
    for size, channels in CONV_OUTPUTS:
        shape = (512, size, size, channels)
        levels = torch.tensor([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0],
                              device="cuda")
        y = levels[torch.randint(0, 6, shape, generator=gen,
                                 device="cuda")].bfloat16()
        bias = levels[torch.randint(0, 6, (channels,), generator=gen,
                                    device="cuda")] * 0.5
        g = torch.randn(512, size // 2, size // 2, channels, generator=gen,
                        device="cuda").bfloat16()
        dz_ref, db_ref = conv_fused.relu_maxpool_backward_reference(g, y,
                                                                    bias)
        scale = float(g.float().abs().sum(dim=(0, 1, 2)).max())
        dst = torch.empty_like(y)
        runs, got = {}, {}
        for n in names:
            lib = libs[n][0]
            dz = torch.empty_like(y)
            db = torch.empty(channels, dtype=torch.float32, device="cuda")
            if hasattr(lib, "vqa_relu_maxpool_backward_vector"):
                call = (g.data_ptr(), y.data_ptr(), bias.data_ptr(),
                        dz.data_ptr(), *shape, 1)
                blocks = lib.vqa_relu_maxpool_backward_blocks(*call)
                vector = lib.vqa_relu_maxpool_backward_vector(*call)
            else:
                blocks, vector = lib.vqa_relu_maxpool_backward_blocks(
                    512, size), 0
            partial = torch.empty(blocks, channels, dtype=torch.float32,
                                  device="cuda")

            def run(lib=lib, dz=dz, db=db, partial=partial, n=n):
                code = lib.vqa_relu_maxpool_backward(
                    g.data_ptr(), y.data_ptr(), bias.data_ptr(),
                    dz.data_ptr(), db.data_ptr(), partial.data_ptr(),
                    *shape, 1, stream)
                assert code == 0, f"{n} kernel C: CUDA error {code}"
                return dz, db
            runs[n] = run
            dz, db = run()
            try:
                torch.cuda.synchronize()
            except RuntimeError as err:
                raise SystemExit(f"kernel C {shape} {n}: {err}")
            got[n] = (dz.clone(), db.clone())
            print(f"kernel C {list(shape)} {n}: {blocks} blocks, vector "
                  f"{bool(vector)}, dz equal bits "
                  f"{torch.equal(got[n][0], dz_ref)}, db rel err "
                  f"{float((db - db_ref).abs().max()) / scale:.3e}, db bits "
                  f"of {names[0]} {torch.equal(db, got[names[0]][1])}")
        del dz_ref, db_ref
        moved = (g.numel() + 2 * y.numel()) * 2 + channels * 8
        copied = 2 * y.numel() * 2
        order = names + ["copy"]
        ms = dict.fromkeys(order, 0.0)
        for n in order + order[::-1]:
            fn = runs[n] if n in runs else (lambda: dst.copy_(y))
            ms[n] += timed(fn, 10) / 2
        print(f"kernel C {list(shape)} ms (bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} by bytes, "
              f"{moved / 1e9:.3f} GB): " + ", ".join(
                  f"{n} {v:.4f} ({(copied if n == 'copy' else moved) / v / 1e6:.0f} GB/s)"
                  for n, v in ms.items()))
        for n in order:
            total[n] += ms[n]
        moved_total += moved
        copied_total += copied
        del y, g, dst, got, runs
    print(f"kernel C, the three conv outputs, ms (bound "
          f"{moved_total / HBM_BYTES_PER_S * 1e3:.4f} by bytes): " + ", ".join(
              f"{n} {v:.4f} ({(copied_total if n == 'copy' else moved_total) / v / 1e6:.0f} GB/s)"
              for n, v in total.items()))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
