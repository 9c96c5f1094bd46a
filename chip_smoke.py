#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dl_vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

1. device: the card's name and power limit, torch / CUDA / nvcc versions;
2. build: compiles the port's CUDA kernels from dl_vqa_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, in bf16 and f32, then timed in turns
   (plain, kernel, kernel, plain) with CUDA events;
4. slice: a Predictor at full reference width (ModelConfig defaults, bf16,
   random weights from the seed, an in-memory vocab of 15,193 question ids
   and 3,000 answers) answers 8 requests; every kernel must have launched
   in that run, the logits must be finite and agree with the plain path;
   then a batch-512 forward is timed on the kernel and the plain path.

Then one JSON line with every kernel's launches (grids launched in the
slice's run; the LSTM launches one per timestep), error and times, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the exit code is nonzero; without CUDA it exits nonzero at once.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEQ_LEN = 23
EMBED = 300
HIDDEN = 1024
BATCH = 512
CONV_OUTPUTS = ((BATCH, 222, 222, 64), (BATCH, 109, 109, 128),
                (BATCH, 52, 52, 256))
# Tolerances, max |kernel - plain|:
#  relu_maxpool: 0; bias, ReLU and the cast commute with max, same bits.
#  attention_pool: 1e-5; f32 sums over 676 positions in another order.
#  lstm f32: 1e-5; f32 dot products of length 1024 in another order,
#    carried through 23 steps (H100: 9e-8).
#  lstm bf16: 1e-3; h is rounded to bf16 before each product, and a last-
#    place difference in f32 flips that rounding for a few elements a
#    step; the flips then feed every later step (H100: 7e-5).
#  logits: the LSTM's difference passes through the attention and the
#    classifier; bf16 5e-4 (H100: 1.0e-4), f32 1e-5 (H100: 3e-8).
TOL = {"relu_maxpool": 0.0, "attention_pool": 1e-5, "lstm_f32": 1e-5,
       "lstm_bf16": 1e-3, "logits_bf16": 5e-4, "logits_f32": 1e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_pair(torch, plain, kernel, iters: int, warmup: int = 2):
    """Mean ms of each callable, timed plain, kernel, kernel, plain."""
    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for _ in range(warmup):
        plain()
        kernel()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_phase(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    log(card)
    from dl_vqa_tpu_torch.ops import _native

    nvcc = subprocess.run([_native._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    log(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
        f" | CUDA {torch.version.cuda} | nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}")
    return card


def build_phase() -> None:
    from dl_vqa_tpu_torch.ops import _native

    _native.library()
    log(f"build: nvcc {' '.join(_native.NVCC_FLAGS)} -> ok in "
        f"{_native.build_seconds():.1f} s")


def lstm_inputs(torch, gen, batch, dtype, device):
    from dl_vqa_tpu_torch.ops.lstm import input_projection, reverse_valid_prefix

    bound = 1.0 / HIDDEN ** 0.5

    def u(*shape):
        return (torch.rand(*shape, generator=gen, device=device) * 2 - 1) * bound

    def direction():
        return {"weight_ih": u(4 * HIDDEN, EMBED),
                "weight_hh": u(4 * HIDDEN, HIDDEN),
                "bias": u(4 * HIDDEN) + u(4 * HIDDEN)}

    x = torch.tanh(torch.randn(batch, SEQ_LEN, EMBED, generator=gen,
                               device=device)).to(dtype)
    lengths = torch.randint(1, SEQ_LEN + 1, (batch,), generator=gen,
                            device=device, dtype=torch.int32)
    lengths[0] = 1
    lengths[-1] = SEQ_LEN
    fwd, bwd = direction(), direction()
    x_proj = torch.stack([
        input_projection(x, fwd),
        input_projection(reverse_valid_prefix(x, lengths), bwd)])
    w_hh = torch.stack([fwd["weight_hh"].to(dtype), bwd["weight_hh"].to(dtype)])
    return x_proj, w_hh, lengths


def kernel_phase(torch, seed: int) -> dict:
    from dl_vqa_tpu_torch.ops.attention_pool import (
        attention_pool_cuda, attention_pool_reference)
    from dl_vqa_tpu_torch.ops.conv_fused import (
        relu_maxpool_cuda, relu_maxpool_reference)
    from dl_vqa_tpu_torch.ops.lstm import lstm_recurrence_reference
    from dl_vqa_tpu_torch.ops.lstm_cuda import lstm_recurrence_cuda

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    summary = {}

    # Kernel 1: LSTM recurrence, both directions per launch.
    errs, timing = [], None
    for dtype, tol in ((torch.bfloat16, TOL["lstm_bf16"]),
                       (torch.float32, TOL["lstm_f32"])):
        for batch in (1, 8, BATCH):
            args = lstm_inputs(torch, gen, batch, dtype, device)
            h, c = lstm_recurrence_cuda(*args)
            hr, cr = lstm_recurrence_reference(*args)
            torch.cuda.synchronize()
            err = max(max_err(h, hr), max_err(c, cr))
            ms, plain_ms = timed_pair(
                torch, lambda: lstm_recurrence_reference(*args),
                lambda: lstm_recurrence_cuda(*args), iters=10)
            log(f"kernel lstm_recurrence {str(dtype)[6:]} B={batch} T={SEQ_LEN}"
                f" H={HIDDEN}: max_abs_err {err:.3e} (tol {tol:g}) | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            require(err <= tol, f"lstm_recurrence {dtype} B={batch}: {err}")
            if dtype == torch.bfloat16:
                errs.append(err)
                if batch == BATCH:
                    timing = (ms, plain_ms)
    summary["lstm_recurrence"] = {"max_abs_err": max(errs), "ms": timing[0],
                                  "plain_ms": timing[1]}

    # Kernel 2: bias + ReLU + 2x2 max pool at the three conv outputs.
    errs, ms_sum, plain_sum = [], 0.0, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in CONV_OUTPUTS:
            y = torch.randn(*shape, generator=gen, device=device).to(dtype)
            b = torch.randn(shape[-1], generator=gen, device=device) * 0.1
            err = max_err(relu_maxpool_cuda(y, b), relu_maxpool_reference(y, b))
            ms, plain_ms = timed_pair(
                torch, lambda: relu_maxpool_reference(y, b),
                lambda: relu_maxpool_cuda(y, b), iters=5)
            log(f"kernel relu_maxpool {str(dtype)[6:]} {list(shape)}: "
                f"max_abs_err {err:.3e} (tol {TOL['relu_maxpool']:g}) | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            require(err <= TOL["relu_maxpool"], f"relu_maxpool {shape}: {err}")
            if dtype == torch.bfloat16:
                errs.append(err)
                ms_sum += ms
                plain_sum += plain_ms
            del y
    summary["relu_maxpool"] = {"max_abs_err": max(errs), "ms": ms_sum,
                               "plain_ms": plain_sum}

    # Kernel 3: glimpse softmax pooling.
    for dtype in (torch.float32, torch.bfloat16):
        v = (torch.randn(BATCH, 26, 26, 256, generator=gen, device=device)
             / 16).to(dtype)
        att = torch.randn(BATCH, 26, 26, 2, generator=gen,
                          device=device).to(dtype)
        err = max_err(attention_pool_cuda(v, att),
                      attention_pool_reference(v, att))
        ms, plain_ms = timed_pair(
            torch, lambda: attention_pool_reference(v, att),
            lambda: attention_pool_cuda(v, att), iters=20)
        log(f"kernel attention_pool {str(dtype)[6:]} v {list(v.shape)} att "
            f"{list(att.shape)}: max_abs_err {err:.3e} (tol "
            f"{TOL['attention_pool']:g}) | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        require(err <= TOL["attention_pool"], f"attention_pool: {err}")
        if dtype == torch.float32:
            summary["attention_pool"] = {"max_abs_err": err, "ms": ms,
                                         "plain_ms": plain_ms}
    return summary


def make_vocab(num_tokens: int, num_answers: int) -> dict:
    words = ("what color is the how many people are there in this picture a "
             "man wearing kind of dog on does it white red blue two").split()
    words += [f"w{i}" for i in range(num_tokens - 1 - len(words))]
    answers = "yes no 2 1 white 3 red blue 4 green black".split()
    answers += [f"a{i}" for i in range(num_answers - len(answers))]
    return {"question": {w: i + 1 for i, w in enumerate(words)},
            "answer": {a: i + 1 for i, a in enumerate(answers)}}


QUESTIONS = [
    "what color is the dog",
    "how many people are in this picture?",
    "is this a man",
    "what",
    "does the man wear a hat?",  # 'wear' and 'hat' are not in the vocab
    "what kind of dog is the man wearing on the picture of the dog in the "
    "red picture and how many are there in this white one",  # > 23 tokens
    "are there two dogs?",
    "is it blue",
]


def slice_phase(torch, seed: int) -> dict:
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.ops.attention_pool import attention_pool_cuda
    from dl_vqa_tpu_torch.ops.conv_fused import relu_maxpool_cuda
    from dl_vqa_tpu_torch.ops.lstm_cuda import lstm_recurrence_cuda
    from dl_vqa_tpu_torch.predict import Predictor

    wrappers = {"lstm_recurrence": lstm_recurrence_cuda,
                "relu_maxpool": relu_maxpool_cuda,
                "attention_pool": attention_pool_cuda}
    cfg = ModelConfig()
    vocab = make_vocab(cfg.num_tokens, cfg.max_answers)
    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    predictor = Predictor(cfg, model, vocab, device="cuda",
                          max_question_length=SEQ_LEN,
                          compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (len(QUESTIONS), cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)

    for fn in wrappers.values():
        fn.launches = 0
    answers = predictor.predict(images, QUESTIONS, top_k=3)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for question, top in zip(QUESTIONS, answers):
        log(f"request {question!r} -> " + ", ".join(
            f"{a} {p:.4f}" for a, p in top))
    log(f"slice: {len(answers)} requests answered, kernel launches "
        f"{json.dumps(launches)}")
    require(len(answers) == len(QUESTIONS), "one answer list per request")
    require(all(len(top) == 3 for top in answers), "top-3 per request")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    encoded, lengths = predictor.encode_questions(QUESTIONS)
    for dtype, tol in ((torch.bfloat16, TOL["logits_bf16"]),
                       (torch.float32, TOL["logits_f32"])):
        predictor.compute_dtype = dtype
        kernel = predictor.forward_logits(images, encoded, lengths)
        plain = predictor.forward_logits(images, encoded, lengths,
                                         plain_ops=True)
        err = float(np.abs(kernel - plain).max())
        log(f"slice logits {str(dtype)[6:]} {list(kernel.shape)}: finite "
            f"{bool(np.isfinite(kernel).all())}, max |kernel - plain| "
            f"{err:.3e} (tol {tol:g}), max |logit| {np.abs(plain).max():.3e}")
        require(kernel.shape == (len(QUESTIONS), cfg.max_answers),
                "logits shape")
        require(bool(np.isfinite(kernel).all()), "finite logits")
        require(err <= tol, f"kernel vs plain logits {dtype}: {err}")
    predictor.compute_dtype = torch.bfloat16

    # Throughput at batch 512, inputs already on the card.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs = torch.randint(0, 256, (BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device="cuda", dtype=torch.uint8)
    lens = torch.randint(1, SEQ_LEN + 1, (BATCH,), generator=gen,
                         device="cuda", dtype=torch.int32)
    qs = torch.randint(1, cfg.num_tokens, (BATCH, SEQ_LEN), generator=gen,
                       device="cuda", dtype=torch.int32)
    qs = qs * (torch.arange(SEQ_LEN, device="cuda")[None] < lens[:, None])

    def forward(plain_ops):
        with torch.inference_mode():
            return model(imgs, qs, lens, compute_dtype=torch.bfloat16,
                         plain_ops=plain_ops)

    torch.cuda.reset_peak_memory_stats()
    ms, plain_ms = timed_pair(torch, lambda: forward(True),
                              lambda: forward(False), iters=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = forward(False)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), "finite batch-512 logits")
    log(f"forward B={BATCH} bf16: kernel path {ms:.3f} ms = "
        f"{BATCH / ms * 1e3:.1f} QA/s | plain path {plain_ms:.3f} ms = "
        f"{BATCH / plain_ms * 1e3:.1f} QA/s | peak memory {peak:.2f} GiB")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import dl_vqa_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    start = time.perf_counter()
    device_phase(torch)
    build_phase()
    summary = kernel_phase(torch, args.seed)
    launches = slice_phase(torch, args.seed)
    log(f"total {time.perf_counter() - start:.1f} s")

    sources = {
        "lstm_recurrence": ("dl_vqa_tpu_torch/csrc/lstm_recurrence.cu",
                            "dl_vqa_tpu/ops/lstm_pallas.py:139"),
        "relu_maxpool": ("dl_vqa_tpu_torch/csrc/relu_maxpool.cu",
                         "dl_vqa_tpu/ops/conv_fused.py:375"),
        "attention_pool": ("dl_vqa_tpu_torch/csrc/attention_pool.cu",
                           "dl_vqa_tpu/ops/attention_pool.py:36"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **summary[name]}
        for name, (src, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
