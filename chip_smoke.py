#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dl_vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

1. device: the card's name and power limit, torch / CUDA / nvcc versions;
2. build: compiles the port's CUDA kernels from dl_vqa_tpu_torch/csrc;
3. kernels: each of the twelve kernels against its plain PyTorch version on
   the card, at the serving and training paths' shapes, in bf16 and f32,
   then timed in turns (plain, kernel, kernel, plain) with CUDA events;
   beside each time, the least time the card could take for the same work
   (bytes over the memory rate or operations over the peak rate,
   whichever is larger) and, where one exists, a PyTorch call that
   computes the same function (kernels 6 to 8 timed in turns with it, and
   kernel 6 also with the unfused block it replaces, cuDNN's conv then
   kernel 2: ``unfused_ms``); kernel C beside a copy of the same conv
   output (``copy_ms``), both rates in GB/s; kernel B's 23 steps each held
   to the plain step's bits, timed through the entry a backward uses
   (checked once) and through the wrapper that checks every call
   (``checked_ms``), beside the whole backward with its products; kernel
   9's eight cases one by one and in one launch;
4. slice: a Predictor at full reference width (ModelConfig defaults, bf16,
   random weights from the seed, an in-memory vocab of 15,193 question ids
   and 3,000 answers) answers 8 requests; every serving kernel must have
   launched in that run, the logits must be finite and agree with the
   plain path; then a batch-512 forward is timed on both paths;
5. train: a trainer at the same width (bf16, batch 512, dropout 0.3, Adam)
   takes 8 steps on one batch and one eval step; the loss must fall, the
   parameters stay finite and all six kernels launch; at batch 8 and
   dropout 0 the kernel path's gradients and eval step are held to the
   plain path's; then the train step is timed on both paths, and run with
   four accumulated micro-batches. ``--profile`` adds a table of device
   time by kernel over two train steps (and, in phase 7, over two
   forwards with the flip on);
6. the ViT model of ``config_vit.yaml`` (224 px, patch 16, 196 tokens,
   width 256, 4 layers, 4 heads of 64; the config is built here, without
   PyYAML) through phases 4 and 5 again: 8 requests and a batch-512
   forward, then 8 train steps, the gradient and eval checks at batch 8
   and the timed train step;
7. both models with ``fused_ops=True``, which flips the image encoder to
   the fused ops (kernel 6, the tap-GEMM conv + ReLU + pool; kernel 7, the
   stem; kernel 8, the ViT block's LN + MLP): the same 8 requests, the
   logits held to the unfused kernel path and to the plain path, the
   batch-512 forward timed with the flip on and off; one eval step of each
   model with the flip on, its loss held to the unfused step's at batch 8;
   and one CNN train step with the flip on, its gradients held to the
   unfused step's at batch 8, timed both ways;
8. the layout probe's eight cases through their dispatch, in one launch.

Every path (CNN serving, CNN training, ViT serving, ViT training, then CNN
and ViT serving, CNN and ViT evaluation and CNN training with the flip on,
and the layout probe) is driven with the kernels' launch counts set to 0
just before it and read just after; on every path kernels C and B run
their vector kernels and kernel 7 its tensor-core kernel
(``FAST_PATHS``). Then
one JSON line with every kernel's launches (grids launched in those runs;
the LSTM recurrence one a call in bf16, the LSTM backward one per
timestep, the pool backward two per call),
error, times and bound, and as the last line ``{"ok": true, "device":
{...}}``. Every time printed was taken on the
card whose name and power limit the first line gives.
Any failed check raises and the exit code is nonzero; without CUDA it
exits nonzero at once. Imports no JAX.
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
#  lstm save mode: final (h, c) equal kernel 1's to the bit; the saved
#    gates and carries as kernel 1's tolerances, for the same reasons.
#  lstm backward, the whole of it: 1e-5 on dgates and 1e-5 of its largest
#    entry on dW_hh; the products between the steps are the same calls on
#    both sides (H100: both 0 since kernel B gives the plain bits).
#  lstm_backward_step: 0 at every step, fed the plain version's inputs:
#    kernel B rounds each product and sum once in the plain version's
#    order (the _rn intrinsics, no FMA contraction), with expf and tanhf
#    as torch's kernels call them.
#  relu_maxpool_backward: dz 0, a routing without arithmetic; db 1e-5 of
#    the largest sum of |g| over a channel: the same rounded values summed
#    in another order.
#  gradients, kernel path against plain path at batch 8, per tensor, as
#    |kernel - plain| over |plain| in the 2-norm, so the limit is a share
#    of the tensor's typical entry and not of its largest. f32 2e-4: sums
#    in another order, cuDNN's weight gradients use atomics, and the
#    attention's gradients are differences of nearly equal sums (H100:
#    4.0e-5 on x_conv's weight, 5e-7 outside the attention). bf16 1e-2
#    (H100: 1.3e-3, conv0's bias), and 1e-1 for the attention's tensors
#    (H100: 3.7e-2, q_lin's weight): the two LSTM forwards differ by bf16
#    flips of h, the question vector moves by 1e-4, and that flips bf16
#    roundings and ReLU gates all over the [B, 26, 26, 1024] attention
#    tensor, whose gradients sum with heavy cancellation at batch 8. That
#    noise is the plain bf16 path's too, so besides, both paths' bf16
#    gradients are measured against the plain path's f32 gradients, and
#    per tensor the kernel path may lie at most GRADS_BF16_RATIO times as
#    far from them as the plain path does (H100: 1.013 times, where the
#    plain path lies 5e-2 to 1.5e-1 away).
#  eval loss: relative, f32 1e-5, bf16 5e-4, as the logits.
#  vit_attention, vit_attention_backward f32: 1e-5; f32 sums over 196 keys
#    (or queries) in another order, on values of order 1 (H100: 4e-7).
#  vit_attention, vit_attention_backward bf16: the f32 results agree as
#    above, so the rounded ones are equal except where a last-place
#    difference moves a bf16 rounding (of e, w, dz or the output) by one
#    step: at most 1 bf16 step (2^-8) of the largest output for the
#    forward and 2 for the backward, whose w and dz are rounded on the way,
#    and at most VIT_DIFFER of the elements differ at all.
#  ViT gradients, kernel path against plain path at batch 8: as the CNN
#    model's, and 5e-2 in bf16 for the image encoder's tensors, whose
#    cotangents pass four blocks in bf16 after kernel 5's one-step flips.
#  conv_relu_pool_fused, conv_relu_pool_stem f32: 1e-5; f32 sums of 27 to
#    1152 products of order 0.03 in another order than cuDNN's.
#  the same in bf16, and vit_mlp_fused: the f32 sums agree as above, so the
#    rounded outputs are equal except where that difference moves a
#    rounding. Kernels 6 and 7 round once: at most 1 bf16 step of the
#    element (2^-7 relative, FUSED_DIFFER of the elements). Kernel 8 rounds
#    ln and the hidden units on the way, and a flip there moves the f32 sum
#    by a bf16 step of ln or of a hidden unit times a weight, whatever the
#    output's size: per element at most 2 steps of the element (H100: 1
#    where |out| >= 0.25) or 2^-8 next to zero (H100: 2.0e-3 at worst where
#    |out| < 0.25; a dropped bias b2, up to 1/32, would not pass), and at
#    most FUSED_DIFFER of the elements differ at all (H100: 0.2%).
#    Kernel 8 f32: 1e-5 of the largest output.
#  layout_cases: 0; moves and a max.
#  kernel 6's gradients at batch 8 against the unfused block's: the same
#    conv output, the same kernel C, the same cuDNN gradient calls, which
#    sum with atomics: 1e-5 of the norm in f32, 1e-3 in bf16.
#  logits with fused_ops on, kernel path against plain path: as the other
#    logits (H100: bf16 1.2e-4 and 1.3e-4, f32 3.7e-8).
#  logits with fused_ops on against off, both on the kernel path: f32 as
#    the other logits (H100: 2.0e-8). In bf16 the fused ops round once
#    where the unfused path rounds twice (the conv output before the bias;
#    the MLP output before the residual), so features move by a bf16 step
#    here and there and the logits, of size 0.13, follow: 1e-3, five times
#    what the card showed (H100: CNN 2.0e-4, ViT 1.1e-4).
#  gradients of the fused_ops train step against the unfused step's at
#    batch 8, per tensor in the 2-norm as above. f32 2e-4 (H100: 6e-7 at
#    worst outside the attention), and 5e-3 for the attention's tensors
#    (H100: q_lin's weight 1.7e-3): kernel 6 sums in another order than
#    cuDNN, the image features move by 1e-6, and those gradients are
#    differences of nearly equal sums over [8, 26, 26, 1024]. bf16: the
#    two forwards differ by the roundings above, so the two steps are two
#    draws of the bf16 path's own noise, each 5e-2 to 1.5e-1 away from the
#    f32 gradients on the attention's tensors: 2.5e-1 between them there
#    (H100: q_lin's weight 9.7e-2), 5e-2 on every other tensor (H100:
#    conv0's weight 1.4e-2); and the step with fused_ops on may lie at most
#    GRADS_BF16_RATIO times as far from the unfused step's f32 gradients as
#    the unfused bf16 step does.
TOL = {"fused_f32": 1e-5, "fused_bf16_steps": 1, "vit_mlp_bf16_steps": 2,
       "vit_mlp_bf16_floor": 2.0 ** -8,
       "layout_cases": 0.0, "fused_grads_f32": 1e-5, "fused_grads_bf16": 1e-3,
       "logits_bf16_fused_cnn": 1e-3, "logits_bf16_fused_vit": 1e-3,
       "grads_f32_fused_attention": 5e-3, "grads_bf16_fused": 5e-2,
       "grads_bf16_fused_attention": 2.5e-1,
       "vit_attention_f32": 1e-5, "vit_attention_bf16_steps": 1,
       "vit_attention_backward_bf16_steps": 2, "grads_bf16_vit_image": 5e-2,
       "relu_maxpool": 0.0, "attention_pool": 1e-5, "lstm_f32": 1e-5,
       "lstm_bf16": 1e-3, "logits_bf16": 5e-4, "logits_f32": 1e-5,
       "lstm_backward": 1e-5, "lstm_backward_step": 0.0,
       "pool_backward_dz": 0.0,
       "pool_backward_db": 1e-5, "grads_f32": 2e-4, "grads_bf16": 1e-2,
       "grads_bf16_attention": 1e-1,
       "loss_f32": 1e-5, "loss_bf16": 5e-4}
# Published peaks of an H100 SXM at its full 700 W: device memory rate,
# dense bf16 tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
GRADS_BF16_RATIO = 1.5
VIT_DIFFER = 0.02
FUSED_DIFFER = 0.02
# Kernel 6's blocks at the reference width: input height, Cin, Cout.
FUSED_BLOCKS = ((111, 64, 128), (54, 128, 256))
STEM_BLOCK = (224, 3, 64)
LAYOUT_BLOCK = (16, 32)  # rows and width of the layout probe's block
VIT_WIDTH, VIT_HIDDEN = 256, 1024
VIT_TOKENS, VIT_HEADS, VIT_HEAD = 196, 4, 64
TRAIN_STEPS = 8
INITIAL_LR = 5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of one callable, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(torch, plain, kernel, iters: int, warmup: int = 2):
    """Mean ms of each callable, timed plain, kernel, kernel, plain."""
    for _ in range(warmup):
        plain()
        kernel()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (timed(torch, fn, iters, warmup=0)
                      for fn in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def timed_turns(torch, fns, iters: int, warmup: int = 2):
    """Mean ms of each callable, timed in the order given and back."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    ms = [0.0] * len(fns)
    for i in list(range(len(fns))) + list(range(len(fns)))[::-1]:
        ms[i] += timed(torch, fns[i], iters, warmup=0) / 2
    return ms


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved_bytes: float, operations: float, kind: str) -> dict:
    """The least ms the card could take: every input read once and every
    output written once at the memory rate, or the operations at the peak
    rate of their type (``kind``), whichever is larger."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = operations / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_norm(a, b) -> float:
    """``|a - b| / |b|`` in the 2-norm."""
    return float((a.float() - b.float()).norm() / b.float().norm())


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
    """``(x_proj, weight_hh)`` in ``dtype``, int32 ``lengths`` and the f32
    master ``weight_hh``, at the reference width."""
    from dl_vqa_tpu_torch.ops.lstm import (
        input_projections, reverse_valid_prefix)

    limit = 1.0 / HIDDEN ** 0.5

    def u(*shape):
        return (torch.rand(*shape, generator=gen, device=device) * 2 - 1) * limit

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
    x_proj = input_projections(
        [x, reverse_valid_prefix(x, lengths)], [fwd, bwd]).to(dtype)
    master = torch.stack([fwd["weight_hh"], bwd["weight_hh"]])
    return x_proj, master.to(dtype), lengths, master


def recurrence_grids(torch) -> int:
    """Grids one bf16 call of kernel 1 or A launches at D = 2, H = 1024:
    one persistent launch where the plan has room, else one a timestep. A
    card of 128 SMs or more (an H100 SXM has 132) must have the plan: a
    change that lost it would otherwise pass here on the per-step grids."""
    from dl_vqa_tpu_torch.ops.lstm_cuda import persistent_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = persistent_plan(2, HIDDEN, torch.bfloat16, sms)
    require(plan is not None or sms < 128,
            f"no persistent plan for D=2, H={HIDDEN} bf16 on {sms} SMs")
    return SEQ_LEN if plan is None else 1


def lstm_library_ms(torch, gen, device, lengths, train: bool) -> float:
    """ms of one ``nn.LSTM(bidirectional=True)`` forward (cuDNN) on a
    PackedSequence of ``lengths``, packed before the timing: kernel 1's
    yardstick in eval mode, kernel A's in train mode (which keeps what the
    backward needs). It also does the input GEMM, which kernels 1 and A
    leave outside. In fp16, which has bf16's bytes and operations: PyTorch
    flattens no bf16 weights for cuDNN, so a bf16 module repacks them on
    every call (and its time swings with that)."""
    from torch.nn.utils.rnn import pack_padded_sequence

    lstm = torch.nn.LSTM(EMBED, HIDDEN, batch_first=True,
                         bidirectional=True).to(device, torch.float16)
    lstm.flatten_parameters()
    lstm.train(train)
    x = torch.tanh(torch.randn(len(lengths), SEQ_LEN, EMBED, generator=gen,
                               device=device)).to(torch.float16)
    packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                  enforce_sorted=False)
    with torch.set_grad_enabled(train):
        return timed(torch, lambda: lstm(packed), iters=10)


def lstm_kernels(torch, gen, device, summary) -> None:
    """Kernel 1, its save mode (kernel A) and the backward step (kernel
    B) at T=23, H=1024, two directions."""
    from dl_vqa_tpu_torch.ops.lstm import (
        lstm_backward_step_reference, lstm_recurrence_reference,
        lstm_recurrence_save_reference, lstm_saved_state_backward)
    from dl_vqa_tpu_torch.ops.lstm_cuda import (
        lstm_backward_step_cuda, lstm_backward_step_launcher,
        lstm_recurrence_cuda, lstm_recurrence_save_cuda)

    def report(name, dtype, batch, err, tol, ms, plain_ms, extra=""):
        log(f"kernel {name} {str(dtype)[6:]} B={batch} T={SEQ_LEN} "
            f"H={HIDDEN}: max_abs_err {err:.3e} (tol {tol:g}) | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms{extra}")
        require(err <= tol, f"{name} {dtype} B={batch}: {err} > {tol}")

    by_batch = {"lstm_recurrence": {}, "lstm_recurrence_save": {}}
    for dtype, tol in ((torch.bfloat16, TOL["lstm_bf16"]),
                       (torch.float32, TOL["lstm_f32"])):
        main = dtype == torch.bfloat16
        # 1, 8 and 64 are serving buckets of serve.py, 512 the batch of the
        # paths below.
        for batch in (1, 8, 64, BATCH):
            # f32 at batch 512 is off the main path and slow on both sides.
            iters = (10 if main else 3) if batch == BATCH else 20
            x_proj, w_hh, lengths, master = lstm_inputs(
                torch, gen, batch, dtype, device)
            args = (x_proj, w_hh, lengths)
            # Steps that the data needs: padded ones change nothing.
            steps = int(lengths.sum()) * x_proj.shape[0]
            product_ops = 2.0 * steps * 4 * HIDDEN * HIDDEN
            kind = "bf16" if main else "f32"

            before = lstm_recurrence_cuda.launches
            h, c = lstm_recurrence_cuda(*args)
            # In bf16 the call is the persistent kernel where the card has
            # a plan, not the per-step grids.
            require(not main or lstm_recurrence_cuda.launches - before
                    == recurrence_grids(torch),
                    f"lstm_recurrence bf16 B={batch}: "
                    f"{lstm_recurrence_cuda.launches - before} grids")
            hr, cr = lstm_recurrence_reference(*args)
            torch.cuda.synchronize()
            err = max(max_err(h, hr), max_err(c, cr))
            ms, plain_ms = timed_pair(
                torch, lambda: lstm_recurrence_reference(*args),
                lambda: lstm_recurrence_cuda(*args), iters=iters)
            library_ms = (lstm_library_ms(torch, gen, device, lengths,
                                          train=False) if main else None)
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     **bound(nbytes(x_proj, w_hh, lengths, h, c),
                             product_ops, kind)}
            report("lstm_recurrence", dtype, batch, err, tol, ms, plain_ms,
                   "" if library_ms is None else
                   f", fp16 nn.LSTM eval (with the input GEMM) "
                   f"{library_ms:.4f} ms | bound {entry['bound_ms']:.4f} ms "
                   f"by {entry['bound_by']}")
            if main:
                by_batch["lstm_recurrence"][batch] = entry

            # Kernel A: kernel 1's bits, plus the saved gates and carries.
            before = lstm_recurrence_save_cuda.launches
            saved = lstm_recurrence_save_cuda(*args)
            require(not main or lstm_recurrence_save_cuda.launches - before
                    == recurrence_grids(torch),
                    f"lstm_recurrence_save bf16 B={batch}: "
                    f"{lstm_recurrence_save_cuda.launches - before} grids")
            plain_saved = lstm_recurrence_save_reference(*args)
            torch.cuda.synchronize()
            require(torch.equal(saved[0], h) and torch.equal(saved[1], c),
                    f"save mode changed kernel 1's bits ({dtype}, B={batch})")
            err = max(max_err(a, b) for a, b in zip(saved, plain_saved))
            del plain_saved
            ms, plain_ms = timed_pair(
                torch, lambda: lstm_recurrence_save_reference(*args),
                lambda: lstm_recurrence_save_cuda(*args), iters=iters)
            library_ms = (lstm_library_ms(torch, gen, device, lengths,
                                          train=True) if main else None)
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     **bound(nbytes(x_proj, w_hh, lengths, *saved),
                             product_ops, kind)}
            report("lstm_recurrence_save", dtype, batch, err, tol, ms,
                   plain_ms, " | final (h, c) equal kernel 1's bits" + (
                       "" if library_ms is None else
                       f" | fp16 nn.LSTM train-mode forward (with the input "
                       f"GEMM) {library_ms:.4f} ms | bound "
                       f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}"))
            if main:
                by_batch["lstm_recurrence_save"][batch] = entry
            if batch == 1:
                continue

            # Kernel B: the whole backward from saved states on both
            # paths, then its T launches alone against T plain steps.
            _, _, gates, c_all, h_all = saved
            dh = torch.randn(h.shape, generator=gen, device=device)
            dc = torch.randn(h.shape, generator=gen, device=device)
            vector_before = lstm_backward_step_cuda.launches_vector
            got = lstm_saved_state_backward(gates, c_all, h_all, master,
                                            lengths, dh, dc, plain=False)
            # The model's shapes take the vector kernel, every step.
            require(lstm_backward_step_cuda.launches_vector - vector_before
                    == SEQ_LEN, f"lstm backward {dtype} B={batch}: "
                    f"{lstm_backward_step_cuda.launches_vector - vector_before}"
                    f" of {SEQ_LEN} grids on the vector kernel")
            want = lstm_saved_state_backward(gates, c_all, h_all, master,
                                             lengths, dh, dc, plain=True)
            torch.cuda.synchronize()
            whole_err = max_err(got[0], want[0])
            dw_err = max_err(got[1], want[1]) / float(want[1].abs().max())
            require(whole_err <= TOL["lstm_backward"],
                    f"lstm backward dgates {dtype} B={batch}: {whole_err}")
            require(dw_err <= TOL["lstm_backward"],
                    f"lstm backward dW_hh {dtype} B={batch}: {dw_err}")
            dgates = got[0]
            del got, want
            whole_ms, whole_plain_ms = timed_pair(
                torch,
                lambda: lstm_saved_state_backward(
                    gates, c_all, h_all, master, lengths, dh, dc, plain=True),
                lambda: lstm_saved_state_backward(
                    gates, c_all, h_all, master, lengths, dh, dc,
                    plain=False), iters=3)
            keep_all = (torch.arange(SEQ_LEN, device=device)[:, None]
                        < lengths[None, :])
            zeros = torch.zeros_like(dh)

            def plain_step(t, dh_t, dc_t):
                return lstm_backward_step_reference(
                    gates[:, t], c_all[:, t],
                    c_all[:, t - 1] if t else zeros, keep_all[t], dh_t, dc_t)

            # Every step fed the plain version's inputs of that step: its
            # bits (max_err sees no sign of a zero).
            err = 0.0
            dh_t, dc_t = dh, dc
            for t in reversed(range(SEQ_LEN)):
                want = plain_step(t, dh_t, dc_t)
                dh_k, dc_k = dh_t.clone(), dc_t.clone()
                lstm_backward_step_cuda(gates, c_all, lengths, dh_k, dc_k,
                                        dgates, t)
                err = max(err, max_err(dgates[:, t], want[0]),
                          max_err(dh_k, want[1]), max_err(dc_k, want[2]))
                dgates[:, t], dh_t, dc_t = want
            require(err <= TOL["lstm_backward_step"],
                    f"lstm_backward_step {dtype} B={batch}: {err}")

            def thin_steps():
                # What a backward pays: the checks once, then T launches.
                dh_k, dc_k = dh.clone(), dc.clone()
                launch = lstm_backward_step_launcher(gates, c_all, lengths,
                                                     dh_k, dc_k, dgates)
                for t in reversed(range(SEQ_LEN)):
                    launch(t)

            def checked_steps():
                dh_k, dc_k = dh.clone(), dc.clone()
                for t in reversed(range(SEQ_LEN)):
                    lstm_backward_step_cuda(gates, c_all, lengths, dh_k, dc_k,
                                            dgates, t)

            def plain_steps():
                dh_k, dc_k = dh, dc
                for t in reversed(range(SEQ_LEN)):
                    dgates[:, t], dh_k, dc_k = plain_step(t, dh_k, dc_k)

            plain_ms, ms, checked_ms = timed_turns(
                torch, [plain_steps, thin_steps, checked_steps], iters=iters)
            report("lstm_backward_step x23", dtype, batch, err,
                   TOL["lstm_backward_step"], ms, plain_ms,
                   f" (checked once), through the wrapper that checks every "
                   f"call {checked_ms:.4f} ms | vector kernel on all "
                   f"{SEQ_LEN} grids | dW_hh rel err {dw_err:.3e}, dgates "
                   f"of the whole backward max_abs_err {whole_err:.3e} | "
                   f"whole backward with its products: kernel "
                   f"{whole_ms:.3f} ms, plain {whole_plain_ms:.3f} ms")
            if main and batch == BATCH:
                # The 23-step function: the gates and carries of the real
                # steps read once (a padded step needs none), every dgates
                # written once, (dh, dc) once in and once out. What passes
                # from one launch to the next is no input and no output.
                real = float(lengths.sum()) / (SEQ_LEN * batch)
                moved = (real * nbytes(gates, c_all) + nbytes(dgates, lengths)
                         + 2 * nbytes(dh, dc))
                summary["lstm_backward_step"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, "checked_ms": checked_ms,
                    "whole_backward_ms": whole_ms,
                    "whole_backward_plain_ms": whole_plain_ms,
                    "dw_hh_rel_err": dw_err, "real_rows": real,
                    **bound(moved, 40.0 * real * SEQ_LEN * dh.numel(), "f32")}
            del saved, gates, c_all, h_all, dgates
    # The batch-512 entries lead the result line; the serving buckets ride
    # along under "by_batch".
    for name, entries in by_batch.items():
        summary[name] = {**entries[BATCH], "by_batch": {
            str(b): entry for b, entry in entries.items() if b != BATCH}}


def tied_values(torch, shape, dtype, gen, device):
    """Values from six bf16-exact levels, so most pool windows hold ties."""
    levels = torch.tensor([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0], device=device)
    idx = torch.randint(0, 6, shape, generator=gen, device=device)
    return levels[idx].to(dtype)


def pool_kernels(torch, gen, device, summary) -> None:
    """Kernel 2 and its backward (kernel C) at the three conv outputs."""
    import torch.nn.functional as F

    from dl_vqa_tpu_torch.ops.conv_fused import (
        relu_maxpool_backward_cuda, relu_maxpool_backward_reference,
        relu_maxpool_cuda, relu_maxpool_reference)

    totals = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                     "library_ms": None, "bytes": 0, "ops": 0.0}
              for name in ("relu_maxpool", "relu_maxpool_backward")}
    totals["relu_maxpool"]["library_ms"] = 0.0

    def add(name, err, ms, plain_ms, moved, ops, library_ms=None):
        total = totals[name]
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bytes"] += moved
        total["ops"] += ops
        if library_ms is not None:
            total["library_ms"] += library_ms

    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        for shape in CONV_OUTPUTS:
            y = torch.randn(*shape, generator=gen, device=device).to(dtype)
            b = torch.randn(shape[-1], generator=gen, device=device) * 0.1
            out = relu_maxpool_cuda(y, b)
            err = max_err(out, relu_maxpool_reference(y, b))
            ms, plain_ms = timed_pair(
                torch, lambda: relu_maxpool_reference(y, b),
                lambda: relu_maxpool_cuda(y, b), iters=5)
            # The same function as one chain of PyTorch calls, on the NCHW
            # view of the same memory (channels_last).
            y_nchw = y.permute(0, 3, 1, 2)
            b_nchw = b.to(dtype)[None, :, None, None]
            library_ms = timed(
                torch, lambda: F.max_pool2d(F.relu(y_nchw + b_nchw), 2),
                iters=5)
            log(f"kernel relu_maxpool {str(dtype)[6:]} {list(shape)}: "
                f"max_abs_err {err:.3e} (tol {TOL['relu_maxpool']:g}) | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.max_pool2d(F.relu(y + b), 2) {library_ms:.4f} ms")
            require(err <= TOL["relu_maxpool"], f"relu_maxpool {shape}: {err}")
            if main:
                add("relu_maxpool", err, ms, plain_ms, nbytes(y, b, out),
                    3.0 * y.numel(), library_ms)
            del y, y_nchw, out

            # Kernel C on a conv output full of ties, on its vector kernel.
            y = tied_values(torch, shape, dtype, gen, device)
            b = tied_values(torch, shape[-1:], torch.float32, gen,
                            device) * 0.5
            g = torch.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3],
                            generator=gen, device=device).to(dtype)
            before = relu_maxpool_backward_cuda.launches_vector
            dz, db = relu_maxpool_backward_cuda(g, y, b)
            require(relu_maxpool_backward_cuda.launches_vector == before + 2,
                    f"relu_maxpool_backward {shape}: not the vector kernel")
            dz_ref, db_ref = relu_maxpool_backward_reference(g, y, b)
            torch.cuda.synchronize()
            err = max_err(dz, dz_ref)
            routed = float((dz != 0).sum()) / g.numel()
            db_err = max_err(db, db_ref) / float(
                g.float().abs().sum(dim=(0, 1, 2)).max())
            moved = nbytes(g, y, b, dz, db)
            del dz_ref, db_ref
            # The yardstick of its rate: a copy of the conv output, which
            # moves 2 |y| bytes against kernel C's 2 |y| + |g|.
            dst = torch.empty_like(y)
            plain_ms, ms, copy_ms = timed_turns(
                torch, [lambda: relu_maxpool_backward_reference(g, y, b),
                        lambda: relu_maxpool_backward_cuda(g, y, b),
                        lambda: dst.copy_(y)], iters=3)
            copied = 2 * nbytes(y)
            log(f"kernel relu_maxpool_backward {str(dtype)[6:]} "
                f"{list(shape)}: vector kernel, dz max_abs_err {err:.3e} (tol "
                f"{TOL['pool_backward_dz']:g}), db rel err {db_err:.3e} (tol "
                f"{TOL['pool_backward_db']:g}), {routed:.3f} of the windows "
                f"routed | kernel {ms:.4f} ms = {moved / ms / 1e6:.0f} GB/s, "
                f"plain {plain_ms:.4f} ms, dst.copy_(y) {copy_ms:.4f} ms = "
                f"{copied / copy_ms / 1e6:.0f} GB/s | bound "
                f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes")
            require(err <= TOL["pool_backward_dz"],
                    f"relu_maxpool_backward dz {shape}: {err}")
            require(db_err <= TOL["pool_backward_db"],
                    f"relu_maxpool_backward db {shape}: {db_err}")
            if main:
                add("relu_maxpool_backward", err, ms, plain_ms, moved,
                    8.0 * y.numel())
                copy = totals["relu_maxpool_backward"]
                copy["copy_ms"] = copy.get("copy_ms", 0.0) + copy_ms
                copy["copied"] = copy.get("copied", 0) + copied
            del y, g, dz, db, dst
    copy = totals["relu_maxpool_backward"]
    copy["gbps"] = copy["bytes"] / copy["ms"] / 1e6
    copy["copy_gbps"] = copy.pop("copied") / copy["copy_ms"] / 1e6
    for name, total in totals.items():
        moved, ops = total.pop("bytes"), total.pop("ops")
        summary[name] = {**total, **bound(moved, ops, "f32")}


def vit_kernels(torch, gen, device, summary) -> None:
    """Kernels 4 and 5 at S=196, H=4, D=64, batches 1, 8 and 512."""
    import torch.nn.functional as F

    from dl_vqa_tpu_torch.ops.vit_attention import (
        vit_attention_backward_cuda, vit_attention_backward_reference,
        vit_attention_cuda, vit_attention_reference)

    dim = VIT_HEADS * VIT_HEAD

    def check(name, dtype, batch, got, want, steps):
        """``(max_abs_err, tol)``; bf16 also holds the share that differs."""
        err = max_err(got, want)
        if dtype == torch.float32:
            tol, note = TOL["vit_attention_f32"], ""
        else:
            tol = steps * 2.0 ** -8 * float(want.float().abs().max())
            differ = float((got != want).float().mean())
            note = (f", {differ:.2%} of the elements differ (limit "
                    f"{VIT_DIFFER:.0%})")
            require(differ <= VIT_DIFFER,
                    f"{name} {dtype} B={batch}: {differ} differ")
        require(bool(torch.isfinite(got.float()).all()), f"{name}: finite")
        require(err <= tol, f"{name} {dtype} B={batch}: {err} > {tol}")
        return err, tol, note

    def library(x):
        # The same function through one PyTorch call, the split and the
        # merge of the heads included, as the kernel includes them.
        batch = x.shape[0]
        q, k, v = (t.reshape(batch, VIT_TOKENS, VIT_HEADS,
                             VIT_HEAD).transpose(1, 2)
                   for t in x.chunk(3, dim=-1))
        return F.scaled_dot_product_attention(q, k, v).transpose(
            1, 2).reshape(batch, VIT_TOKENS, dim)

    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        kind = "bf16" if main else "f32"
        for batch in (1, 8, BATCH):
            iters = 10 if main or batch < BATCH else 3
            qkv = torch.randn(batch, VIT_TOKENS, 3 * dim, generator=gen,
                              device=device).to(dtype)
            g = torch.randn(batch, VIT_TOKENS, dim, generator=gen,
                            device=device).to(dtype)
            pairs = batch * VIT_HEADS
            product = 2.0 * pairs * VIT_TOKENS * VIT_TOKENS * VIT_HEAD

            out = vit_attention_cuda(qkv, VIT_HEADS)
            torch.cuda.synchronize()
            err, tol, note = check(
                "vit_attention", dtype, batch, out,
                vit_attention_reference(qkv, VIT_HEADS),
                TOL["vit_attention_bf16_steps"])
            ms, plain_ms = timed_pair(
                torch, lambda: vit_attention_reference(qkv, VIT_HEADS),
                lambda: vit_attention_cuda(qkv, VIT_HEADS), iters=iters)
            library_ms = timed(torch, lambda: library(qkv), iters=iters)
            least = bound(nbytes(qkv, out), 2 * product, kind)
            log(f"kernel vit_attention {kind} qkv {list(qkv.shape)}: "
                f"max_abs_err {err:.3e} (tol {tol:.3g}){note} | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention with split and merge "
                f"{library_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
                f"{least['bound_by']}")
            if main and batch == BATCH:
                summary["vit_attention"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, **least}

            dqkv = vit_attention_backward_cuda(qkv, g, VIT_HEADS)
            again = vit_attention_backward_cuda(qkv, g, VIT_HEADS)
            torch.cuda.synchronize()
            require(torch.equal(dqkv, again),
                    f"vit_attention_backward {kind} B={batch}: two runs "
                    "gave other digits")
            err, tol, note = check(
                "vit_attention_backward", dtype, batch, dqkv,
                vit_attention_backward_reference(qkv, g, VIT_HEADS),
                TOL["vit_attention_backward_bf16_steps"])
            del again
            ms, plain_ms = timed_pair(
                torch,
                lambda: vit_attention_backward_reference(qkv, g, VIT_HEADS),
                lambda: vit_attention_backward_cuda(qkv, g, VIT_HEADS),
                iters=iters)
            # The library call's backward alone: its graph is built once
            # on a leaf, then only the gradient is taken (split and merge
            # included, as for the forward).
            leaf = qkv.detach().requires_grad_(True)
            lib_out = library(leaf)
            library_ms = timed(
                torch, lambda: torch.autograd.grad(lib_out, leaf, g,
                                                   retain_graph=True),
                iters=iters)
            del lib_out, leaf
            # Five products: the scores, dv, dw, dq, dk.
            least = bound(nbytes(qkv, g, dqkv), 5 * product, kind)
            log(f"kernel vit_attention_backward {kind} qkv "
                f"{list(qkv.shape)}: max_abs_err {err:.3e} (tol {tol:.3g})"
                f"{note}, the same digits on two runs | kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, the backward of "
                f"F.scaled_dot_product_attention with split and merge "
                f"{library_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
                f"{least['bound_by']}")
            if main and batch == BATCH:
                summary["vit_attention_backward"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, **least}
            del qkv, g, out, dqkv


def conv_case(torch, gen, device, dtype, batch, size, cin, cout, k=3):
    """``x [B, size, size, Cin]`` in ``dtype``, a torch-layout weight and a
    bias at torch's default scale (f32 masters, as the model holds them)."""
    x = torch.randn(batch, size, size, cin, generator=gen,
                    device=device).to(dtype)
    limit = 1.0 / (cin * k * k) ** 0.5
    weight = (torch.rand(cout, cin, k, k, generator=gen, device=device) * 2
              - 1) * limit
    bias = (torch.rand(cout, generator=gen, device=device) * 2 - 1) * limit
    return x, weight, bias


def check_rounded(torch, what, got, want, dtype):
    """Kernels 6 and 7 against their plain version: ``(max_abs_err, note)``.
    f32 within TOL["fused_f32"]; bf16 within one rounding step of each
    element (or the f32 tolerance, next to zero), and few elements differ."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: shape or dtype")
    require(bool(torch.isfinite(got.float()).all()), f"{what}: finite")
    err = max_err(got, want)
    if dtype == torch.float32:
        require(err <= TOL["fused_f32"], f"{what}: {err}")
        return err, f"(tol {TOL['fused_f32']:g})"
    limit = (TOL["fused_bf16_steps"] * 2.0 ** -7 * want.float().abs()).clamp(
        min=TOL["fused_f32"])
    differ = float((got != want).float().mean())
    require(bool(((got.float() - want.float()).abs() <= limit).all()),
            f"{what}: more than a bf16 step apart, max_abs_err {err}")
    require(differ <= FUSED_DIFFER, f"{what}: {differ} of the elements differ")
    return err, (f"(tol 1 bf16 step of the element), {differ:.2%} of the "
                 f"elements differ (limit {FUSED_DIFFER:.0%})")


def layout_inputs(torch, gen):
    """The layout probe's eight cases: the four modes on a ``[16, 32, C]``
    bf16 block, C = 64 and 128, as ``(xs, modes)``."""
    from dl_vqa_tpu_torch.ops.layout_cases import MODES

    xs, modes = [], []
    for channels in (64, 128):
        x = torch.randn(*LAYOUT_BLOCK, channels, generator=gen,
                        device="cuda").to(torch.bfloat16)
        xs += [x] * len(MODES)
        modes += MODES
    return xs, modes


def check_layout(torch, xs, modes, outs) -> None:
    """Every case's output equals its plain version's to the bit."""
    from dl_vqa_tpu_torch.ops.layout_cases import layout_case_reference

    torch.cuda.synchronize()
    for x, mode, got in zip(xs, modes, outs):
        want = layout_case_reference(x, mode)
        require(got.shape == want.shape and torch.equal(got, want),
                f"layout case {mode} C={x.shape[-1]}: bits differ")


def fused_kernels(torch, gen, device, summary) -> None:
    """Kernels 6 to 9 at the shapes the flipped forwards give them (batches
    1, 8 and 512, bf16 and f32), small odd shapes (for kernel 6 also two
    whose weights it streams), and kernel 6's gradients through
    ``ConvReluPoolFused`` against the unfused block's."""
    import torch.nn.functional as F

    from dl_vqa_tpu_torch.ops.conv_fused import (
        conv_nhwc, conv_relu_pool, conv_relu_pool_fused_cuda,
        conv_relu_pool_fused_reference, conv_relu_pool_stem_cuda,
        conv_relu_pool_stem_reference, relu_maxpool_cuda, stem_mma_path)
    from dl_vqa_tpu_torch.ops.layout_cases import (
        layout_case_cuda, layout_case_reference, layout_cases_cuda,
        layout_cases_reference)
    from dl_vqa_tpu_torch.ops.vit_mlp_fused import (
        fused_ln_mlp_cuda, fused_ln_mlp_reference)

    def new_total():
        return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0, "bytes": 0, "ops": 0.0}

    def add(total, err, ms, plain_ms, library_ms, moved, ops,
            unfused_ms=None):
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["library_ms"] += library_ms
        total["bytes"] += moved
        total["ops"] += ops
        if unfused_ms is not None:
            total["unfused_ms"] = total.get("unfused_ms", 0.0) + unfused_ms

    def close(name, total, kind):
        moved, ops = total.pop("bytes"), total.pop("ops")
        summary[name] = {**total, **bound(moved, ops, kind)}

    def conv_block(name, kernel, reference, batch, size, cin, cout, k, dtype,
                   total=None):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        x, weight, bias = conv_case(torch, gen, device, dtype, batch, size,
                                    cin, cout, k)
        before = getattr(kernel, "launches_mma", 0)
        got = kernel(x, weight, bias)
        if kernel is conv_relu_pool_stem_cuda:
            # bf16 at the stem's shape and the odd ones runs on the tensor
            # cores; f32 on the FMA units.
            mma = stem_mma_path(dtype, cin, cout, k)
            require(mma == (dtype == torch.bfloat16)
                    and kernel.launches_mma == before + mma,
                    f"conv_relu_pool_stem {dtype} {size} k={k}: tensor-core "
                    f"kernel {mma}, counted {kernel.launches_mma - before}")
        want = reference(x, weight, bias)
        torch.cuda.synchronize()
        what = f"{name} {kind} x {list(x.shape)} -> {list(got.shape)} k={k}"
        err, note = check_rounded(torch, what, got, want, dtype)
        del want
        iters = 10 if batch < BATCH else 5 if kind == "bf16" else 2
        # The yardsticks: the same block as three PyTorch calls on the NCHW
        # view of the same memory (channels_last), the conv in x's type;
        # and for kernel 6 the unfused block it replaces, conv_nhwc (cuDNN)
        # then kernel 2, which decides the fused_ops flip. All in turns.
        x_nchw = x.permute(0, 3, 1, 2)
        w_lib = weight.to(dtype).contiguous(memory_format=torch.channels_last)
        b_lib = bias.to(dtype)
        fns = [lambda: reference(x, weight, bias),
               lambda: kernel(x, weight, bias),
               lambda: F.max_pool2d(F.relu(F.conv2d(x_nchw, w_lib, b_lib)),
                                    2)]
        if kernel is conv_relu_pool_fused_cuda:
            fns.append(lambda: relu_maxpool_cuda(conv_nhwc(x, weight), bias))
        plain_ms, ms, library_ms, *unfused = timed_turns(torch, fns, iters)
        unfused_ms = unfused[0] if unfused else None
        # Only the conv positions that feed a pool window count.
        ops = 2.0 * got.numel() * 4 * k * k * cin
        moved = nbytes(x, got, bias) + weight.numel() * x.element_size()
        entry = bound(moved, ops, kind)
        log(f"kernel {what}: max_abs_err {err:.3e} {note} | kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, F.max_pool2d(F.relu(F.conv2d(x, "
            f"w, b)), 2) {library_ms:.4f} ms"
            + ("" if unfused_ms is None else
               f", unfused conv_nhwc + kernel 2 {unfused_ms:.4f} ms")
            + f" | bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}")
        if total is not None:
            add(total, err, ms, plain_ms, library_ms, moved, ops, unfused_ms)

    # Kernel 6's last odd shapes are bf16 ones whose weights no block can
    # hold, which it streams a filter row a step.
    for name, kernel, reference, blocks, odd, streamed in (
            ("conv_relu_pool_fused", conv_relu_pool_fused_cuda,
             conv_relu_pool_fused_reference, FUSED_BLOCKS,
             ((37, 16, 32, 3), (24, 16, 32, 5)),
             ((14, 384, 64, 3), (12, 128, 64, 5))),
            ("conv_relu_pool_stem", conv_relu_pool_stem_cuda,
             conv_relu_pool_stem_reference, (STEM_BLOCK,),
             ((21, 3, 8, 3), (28, 3, 8, 5)), ())):
        total = new_total()
        for dtype in (torch.bfloat16, torch.float32):
            main = dtype == torch.bfloat16
            for size, cin, cout, k in odd + (streamed if main else ()):
                conv_block(name, kernel, reference, 2, size, cin, cout, k,
                           dtype)
            for batch in (1, 8, BATCH):
                for size, cin, cout in blocks:
                    conv_block(name, kernel, reference, batch, size, cin,
                               cout, 3, dtype,
                               total if main and batch == BATCH else None)
        close(name, total, "bf16")

    # Kernel 6's gradients: the fused block against the unfused one on one
    # cotangent, at conv1's shape.
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        size, cin, cout = FUSED_BLOCKS[0]
        x, weight, bias = conv_case(torch, gen, device, dtype, 8, size, cin,
                                    cout)
        pooled = (size - 2) // 2
        g = torch.randn(8, pooled, pooled, cout, generator=gen,
                        device=device).to(dtype)
        grads = {}
        for fused in (True, False):
            args = [t.clone().requires_grad_() for t in (x, weight, bias)]
            conv_relu_pool(*args, fused=fused).backward(g)
            grads[fused] = [t.grad for t in args]
        torch.cuda.synchronize()
        rels = [rel_norm(a, b) for a, b in zip(grads[True], grads[False])]
        tol = TOL["fused_grads_" + dname]
        log(f"kernel conv_relu_pool_fused gradients {dname} B=8 "
            f"{list(x.shape)}: |fused - unfused| / |unfused| dx {rels[0]:.3e}"
            f", dw {rels[1]:.3e}, db {rels[2]:.3e} (tol {tol:g})")
        require(max(rels) <= tol, f"kernel 6 gradients {dname}: {rels}")
        del grads, x, g

    # Kernel 8 on the ViT's token rows.
    def mlp_block(batch, seq, dim, hidden, dtype, keep):
        kind = "bf16" if dtype == torch.bfloat16 else "f32"

        def uniform(*shape, fan_in):
            return (torch.rand(*shape, generator=gen, device=device) * 2
                    - 1) / fan_in ** 0.5

        x = torch.randn(batch, seq, dim, generator=gen,
                        device=device).to(dtype)
        args = (x,
                1 + 0.1 * torch.randn(dim, generator=gen, device=device),
                0.1 * torch.randn(dim, generator=gen, device=device),
                uniform(hidden, dim, fan_in=dim), uniform(hidden, fan_in=dim),
                uniform(dim, hidden, fan_in=hidden),
                uniform(dim, fan_in=hidden))
        got = fused_ln_mlp_cuda(*args)
        want = fused_ln_mlp_reference(*args)
        torch.cuda.synchronize()
        what = f"vit_mlp_fused {kind} x {list(x.shape)} F={hidden}"
        require(bool(torch.isfinite(got.float()).all()), f"{what}: finite")
        err, top = max_err(got, want), float(want.float().abs().max())
        if dtype == torch.float32:
            tol = TOL["fused_f32"] * top
            require(err <= tol, f"{what}: {err} > {tol}")
            note = f"(tol {tol:.3g})"
        else:
            limit = (TOL["vit_mlp_bf16_steps"] * 2.0 ** -7
                     * want.float().abs()).clamp(min=TOL["vit_mlp_bf16_floor"])
            differ = float((got != want).float().mean())
            require(bool(((got.float() - want.float()).abs() <= limit).all()),
                    f"{what}: an element lies more than "
                    f"{TOL['vit_mlp_bf16_steps']} bf16 steps from its plain "
                    f"value, max_abs_err {err}")
            require(differ <= FUSED_DIFFER,
                    f"{what}: {differ} of the elements differ")
            note = (f"(tol {TOL['vit_mlp_bf16_steps']} bf16 steps of the "
                    f"element, {TOL['vit_mlp_bf16_floor']:g} next to zero), "
                    f"{differ:.2%} of the elements differ (limit "
                    f"{FUSED_DIFFER:.0%})")
        del want
        iters = 10 if batch < BATCH else 5 if kind == "bf16" else 2
        scale, shift, w1, b1, w2, b2 = (t.to(dtype) for t in args[1:])

        def library():
            ln = F.layer_norm(x, (dim,), scale, shift, 1e-5)
            return x + F.linear(F.relu(F.linear(ln, w1, b1)), w2, b2)

        plain_ms, ms, library_ms = timed_turns(
            torch, [lambda: fused_ln_mlp_reference(*args),
                    lambda: fused_ln_mlp_cuda(*args), library], iters)
        moved = nbytes(x, got, scale, shift, w1, b1, w2, b2)
        ops = 4.0 * batch * seq * dim * hidden
        entry = bound(moved, ops, kind)
        log(f"kernel {what}: max_abs_err {err:.3e} {note} | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.layer_norm + "
            f"F.linear + F.relu + F.linear + add in {kind} {library_ms:.4f} "
            f"ms | bound {entry['bound_ms']:.4f} ms by {entry['bound_by']}")
        if keep:
            summary["vit_mlp_fused"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, **entry}

    for dtype in (torch.bfloat16, torch.float32):
        mlp_block(3, 23, 128, 192, dtype, False)
        for batch in (1, 8, BATCH):
            mlp_block(batch, VIT_TOKENS, VIT_WIDTH, VIT_HIDDEN, dtype,
                      dtype == torch.bfloat16 and batch == BATCH)

    # Kernel 9: the probe's eight cases, to the bit, each on its own (a
    # batch of one, its output made on each call as the library call's is)
    # and all in one launch.
    # The yardstick: each case as one PyTorch call.
    rows, width = LAYOUT_BLOCK
    library = {
        "split": lambda x: x.view(rows, width // 2, 2, -1).amax(2),
        "merge": lambda x: x.view(rows, width // 2, -1).clone(),
        "strided": lambda x: torch.maximum(x[:, 0::2], x[:, 1::2]),
        "shift": lambda x: torch.roll(x, -1, 1),
    }
    xs, modes = layout_inputs(torch, gen)
    outs = [layout_case_cuda(x, mode) for x, mode in zip(xs, modes)]
    check_layout(torch, xs, modes, outs)
    per_case, library_ms = [], 0.0
    for x, mode, out in zip(xs, modes, outs):
        require(torch.equal(library[mode](x), out),
                f"layout case {mode}: the library call computes another "
                "function")
        plain_ms, case_ms, call_ms = timed_turns(
            torch, [lambda: layout_case_reference(x, mode),
                    lambda: layout_case_cuda(x, mode),
                    lambda: library[mode](x)], iters=50)
        log(f"kernel layout_cases {mode} bf16 {list(x.shape)} -> "
            f"{list(out.shape)}: equal bits | one case through its wrapper "
            f"{case_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"one PyTorch call {call_ms:.4f} ms")
        per_case.append({"mode": mode, "channels": x.shape[-1],
                         "ms": case_ms, "plain_ms": plain_ms,
                         "library_ms": call_ms})
        library_ms += call_ms
    outs = layout_cases_cuda(xs, modes)
    check_layout(torch, xs, modes, outs)
    plain_ms, ms = timed_turns(
        torch, [lambda: layout_cases_reference(xs, modes),
                lambda: layout_cases_cuda(xs, modes)], iters=50)
    per_case_ms = sum(case["ms"] for case in per_case)
    log(f"kernel layout_cases, the eight cases in one launch: equal bits | "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; the eight cases one launch "
        f"each {per_case_ms:.4f} ms; the eight PyTorch calls {library_ms:.4f}"
        " ms")
    summary["layout_cases"] = {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "per_case_ms": per_case_ms,
        "per_case": per_case,
        **bound(nbytes(*xs, *outs), 0.0, "f32")}


def kernel_phase(torch, seed: int) -> dict:
    from dl_vqa_tpu_torch.ops.attention_pool import (
        attention_pool_cuda, attention_pool_reference)

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed)
    summary = {}
    lstm_kernels(torch, gen, device, summary)
    pool_kernels(torch, gen, device, summary)
    vit_kernels(torch, gen, device, summary)
    fused_kernels(torch, gen, device, summary)

    # Kernel 3: glimpse softmax pooling, at the CNN's 26 x 26 grid and at
    # the ViT's 14 x 14.
    for grid in (26, 14):
        for dtype in (torch.float32, torch.bfloat16):
            v = (torch.randn(BATCH, grid, grid, 256, generator=gen,
                             device=device) / 16).to(dtype)
            att = torch.randn(BATCH, grid, grid, 2, generator=gen,
                              device=device).to(dtype)
            out = attention_pool_cuda(v, att)
            err = max_err(out, attention_pool_reference(v, att))
            ms, plain_ms = timed_pair(
                torch, lambda: attention_pool_reference(v, att),
                lambda: attention_pool_cuda(v, att), iters=20)
            log(f"kernel attention_pool {str(dtype)[6:]} v {list(v.shape)} "
                f"att {list(att.shape)}: max_abs_err {err:.3e} (tol "
                f"{TOL['attention_pool']:g}) | kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
            require(err <= TOL["attention_pool"], f"attention_pool: {err}")
            if dtype == torch.float32:  # the model pools f32 features
                entry = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None,
                    **bound(nbytes(v, att, out),
                            2.0 * att.numel() * v.shape[-1]
                            + 4.0 * att.numel(), "f32")}
                if grid == 26:
                    summary["attention_pool"] = entry
                else:
                    summary["attention_pool"]["at_14x14"] = entry
                    log(f"bound attention_pool at 14 x 14: "
                        f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}, "
                        f"kernel {ms:.4f} ms = {entry['bound_ms'] / ms:.1%} "
                        "of it")
    for name, entry in summary.items():
        log(f"bound {name}: {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']}, kernel {entry['ms']:.4f} ms = "
            f"{entry['bound_ms'] / entry['ms']:.1%} of it")
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


def kernel_wrappers() -> dict:
    """Every kernel's wrapper, by the name it has in the result line."""
    from dl_vqa_tpu_torch.ops.attention_pool import attention_pool_cuda
    from dl_vqa_tpu_torch.ops.conv_fused import (
        conv_relu_pool_fused_cuda, conv_relu_pool_stem_cuda,
        relu_maxpool_backward_cuda, relu_maxpool_cuda)
    from dl_vqa_tpu_torch.ops.layout_cases import layout_cases_cuda
    from dl_vqa_tpu_torch.ops.lstm_cuda import (
        lstm_backward_step_cuda, lstm_recurrence_cuda,
        lstm_recurrence_save_cuda)
    from dl_vqa_tpu_torch.ops.vit_attention import (
        vit_attention_backward_cuda, vit_attention_cuda)
    from dl_vqa_tpu_torch.ops.vit_mlp_fused import fused_ln_mlp_cuda

    return {"lstm_recurrence": lstm_recurrence_cuda,
            "lstm_recurrence_save": lstm_recurrence_save_cuda,
            "lstm_backward_step": lstm_backward_step_cuda,
            "relu_maxpool": relu_maxpool_cuda,
            "relu_maxpool_backward": relu_maxpool_backward_cuda,
            "attention_pool": attention_pool_cuda,
            "vit_attention": vit_attention_cuda,
            "vit_attention_backward": vit_attention_backward_cuda,
            "conv_relu_pool_fused": conv_relu_pool_fused_cuda,
            "conv_relu_pool_stem": conv_relu_pool_stem_cuda,
            "vit_mlp_fused": fused_ln_mlp_cuda,
            "layout_cases": layout_cases_cuda}


# Kernels that count the grids of their fast path beside all their grids:
# kernel C's and kernel B's vector kernels and kernel 7's tensor-core
# kernel, which every call of a model path takes (the model's shapes, in
# bf16).
FAST_PATHS = {"relu_maxpool_backward": "launches_vector",
              "lstm_backward_step": "launches_vector",
              "conv_relu_pool_stem": "launches_mma"}


def reset_launches(wrappers) -> None:
    """Every launch count to 0, the fast paths' too."""
    for name, fn in wrappers.items():
        fn.launches = 0
        if name in FAST_PATHS:
            setattr(fn, FAST_PATHS[name], 0)


def read_launches(wrappers, what: str) -> dict:
    """The grids each kernel launched since :func:`reset_launches`; fails
    where kernel C, B or 7 launched a grid off its fast path."""
    launches = {kernel: fn.launches for kernel, fn in wrappers.items()}
    for name, counter in FAST_PATHS.items():
        fast = getattr(wrappers[name], counter)
        require(fast == launches[name],
                f"{name} on {what}: {launches[name]} grids, {fast} of them "
                f"counted by {counter}")
    return launches


def vit_config():
    """The model of ``dl_vqa_tpu/config/config_vit.yaml``: the ViT image
    encoder (patch 16, 4 layers, 4 heads, width 256) before the reference
    text encoder, attention and classifier."""
    import dataclasses

    from dl_vqa_tpu_torch.models.configs import ModelConfig

    cfg = ModelConfig()
    return dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, encoder="vit", num_channels=(3, 256), patch_size=16,
        num_layers=4, num_heads=4))


def slice_phase(torch, seed: int, cfg, name: str, expected: dict,
                fused: bool = False, profile: bool = False) -> dict:
    """A Predictor over ``cfg`` answers the requests; ``expected`` holds
    the grids each kernel must have launched for them. ``fused`` serves
    with ``fused_ops=True``: the logits are also held to the unfused kernel
    path, and the forward is timed with the flip on and off."""
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.predict import Predictor

    wrappers = kernel_wrappers()
    vocab = make_vocab(cfg.num_tokens, cfg.max_answers)
    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    predictor = Predictor(cfg, model, vocab, device="cuda",
                          max_question_length=SEQ_LEN,
                          compute_dtype=torch.bfloat16, fused_ops=fused)
    label = name + (" fused_ops" if fused else "")
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (len(QUESTIONS), cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)

    reset_launches(wrappers)
    answers = predictor.predict(images, QUESTIONS, top_k=3)
    launches = read_launches(wrappers, f"the {label} serving path")
    for question, top in zip(QUESTIONS, answers):
        log(f"request {question!r} -> " + ", ".join(
            f"{a} {p:.4f}" for a, p in top))
    log(f"slice {label}: {len(answers)} requests answered, kernel launches "
        f"{json.dumps(launches)}")
    require(len(answers) == len(QUESTIONS), "one answer list per request")
    require(all(len(top) == 3 for top in answers), "top-3 per request")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on the {label} serving path: {launches}, "
            f"expected {expected}")

    encoded, lengths = predictor.encode_questions(QUESTIONS)
    for dtype, tol in ((torch.bfloat16, TOL["logits_bf16"]),
                       (torch.float32, TOL["logits_f32"])):
        predictor.compute_dtype = dtype
        kernel = predictor.forward_logits(images, encoded, lengths)
        plain = predictor.forward_logits(images, encoded, lengths,
                                         plain_ops=True)
        err = float(np.abs(kernel - plain).max())
        if fused:
            predictor.fused_ops = False
            unfused = predictor.forward_logits(images, encoded, lengths)
            predictor.fused_ops = True
            off_err = float(np.abs(kernel - unfused).max())
            off_tol = (TOL["logits_f32"] if dtype == torch.float32
                       else TOL["logits_bf16_fused_" + name])
            log(f"slice {label} logits {str(dtype)[6:]}: max |fused_ops on - "
                f"off| on the kernel path {off_err:.3e} (tol {off_tol:g})")
            require(off_err <= off_tol,
                    f"fused_ops on vs off logits {dtype}: {off_err}")
        log(f"slice {label} logits {str(dtype)[6:]} {list(kernel.shape)}: "
            f"finite {bool(np.isfinite(kernel).all())}, max |kernel - plain| "
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

    def forward(plain_ops=False, fused_ops=fused):
        with torch.inference_mode():
            return model(imgs, qs, lens, compute_dtype=torch.bfloat16,
                         plain_ops=plain_ops, fused_ops=fused_ops)

    if fused:
        ms, off_ms = timed_pair(torch, lambda: forward(fused_ops=False),
                                forward, iters=3)
        peaks = []
        for run in (forward, lambda: forward(fused_ops=False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = run()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        require(bool(torch.isfinite(out).all()), "finite batch-512 logits")
        log(f"forward {name} B={BATCH} bf16, kernel path: fused_ops on "
            f"{ms:.3f} ms = {BATCH / ms * 1e3:.1f} QA/s, peak memory "
            f"{peaks[0]:.2f} GiB | off {off_ms:.3f} ms = "
            f"{BATCH / off_ms * 1e3:.1f} QA/s, peak memory {peaks[1]:.2f} GiB")
        if profile:
            profile_steps(torch, forward, ms, f"{name} forward fused_ops")
        return launches

    torch.cuda.reset_peak_memory_stats()
    ms, plain_ms = timed_pair(torch, lambda: forward(True),
                              lambda: forward(False), iters=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = forward(False)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), "finite batch-512 logits")
    log(f"forward {name} B={BATCH} bf16: kernel path {ms:.3f} ms = "
        f"{BATCH / ms * 1e3:.1f} QA/s | plain path {plain_ms:.3f} ms = "
        f"{BATCH / plain_ms * 1e3:.1f} QA/s | peak memory {peak:.2f} GiB")
    return launches


def make_batch(torch, cfg, batch_size: int, seed: int) -> dict:
    """A training batch on the card, from a seed: uint8 images, 23 token
    ids, lengths 3 ... 23, ten (answer id, annotator count) pairs per
    sample, no padded sample."""
    rng = np.random.default_rng(seed)
    batch = {
        "images": rng.integers(0, 256, (batch_size, cfg.image_size,
                                        cfg.image_size, 3), dtype=np.uint8),
        "questions": rng.integers(
            0, cfg.num_tokens, (batch_size, SEQ_LEN)).astype(np.int32),
        "lengths": rng.integers(3, SEQ_LEN + 1, batch_size).astype(np.int32),
        "answer_indices": rng.integers(
            1, cfg.max_answers + 1, (batch_size, 10)).astype(np.int32),
        "answer_values": rng.integers(0, 11, (batch_size, 10)).astype(np.int32),
        "mask": np.ones(batch_size, dtype=bool),
    }
    return {key: torch.from_numpy(value).cuda() for key, value in batch.items()}


def without_dropout(cfg):
    import dataclasses

    return dataclasses.replace(cfg, **{
        part: dataclasses.replace(getattr(cfg, part), dropout=0.0)
        for part in ("text", "image", "attention", "classifier")})


# Device kernels by the part of the train step they belong to, first match
# wins (names as torch.profiler reports them).
PROFILE_PARTS = (
    ("kernel C, bias+ReLU+pool backward", (
        "relu_maxpool_backward_vector_kernel", "relu_maxpool_backward_kernel",
        "sum_partials_kernel")),
    ("kernel 2, bias+ReLU+pool", ("relu_maxpool_kernel",)),
    ("kernel B, LSTM backward step", ("lstm_backward_step_vector_kernel",
                                      "lstm_backward_step_kernel")),
    ("kernels A and 1, LSTM recurrence", ("lstm_persistent_kernel",
                                          "lstm_step_kernel")),
    ("kernel 3, attention pool", ("attention_pool_kernel",)),
    ("kernel 5, ViT attention backward", ("attention_bwd_mma_kernel",
                                          "attention_bwd_dq_kernel",
                                          "attention_bwd_dkdv_kernel")),
    ("kernel 4, ViT attention", ("attention_mma_kernel",
                                 "attention_fma_kernel")),
    ("kernel 6, fused conv block", ("conv_pool_wgmma_kernel",)),
    ("kernel 7, stem (and kernel 6 in f32)", ("stem_mma_kernel",
                                              "conv_pool_direct_kernel")),
    ("kernel 8, LN + MLP (and its weight packing)",
     ("ln_mlp_wgmma_kernel", "ln_mlp_fma_kernel", "pack_weights_kernel")),
    ("cuDNN convs, forward and backward",
     ("fprop", "dgrad", "wgrad", "cudnn", "Padding", "ImplicitGemm")),
    ("matrix products (cuBLAS)", ("gemm", "cutlass", "gemv", "splitK")),
    ("dropout bits", ("distribution_elementwise",)),
    ("Adam", ("multi_tensor", "Adam")),
    ("reductions", ("reduce_kernel", "softmax")),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
)


def profile_steps(torch, run_step, step_ms: float, what: str,
                  steps: int = 2) -> None:
    """Device time by kernel and by part of the step over ``steps`` runs
    of ``run_step`` (torch.profiler); ``step_ms`` is the step's time
    without the profiler, against which the idle share is stated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(event):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(event, name):
                return getattr(event, name)
        return 0.0

    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    rows = sorted(((device_us(e) / 1e3 / steps, e.count / steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy_ms = sum(row[0] for row in rows)
    log(f"profile {what}: {steps} steps, device kernels {busy_ms:.2f} ms a "
        f"step against {step_ms:.2f} ms a step without the profiler "
        f"({1 - busy_ms / step_ms:.1%} idle)")
    parts = {}
    for ms, calls, key in rows:
        part = next((name for name, words in PROFILE_PARTS
                     if any(word in key for word in words)),
                    "other elementwise passes")
        total = parts.setdefault(part, [0.0, 0.0])
        total[0] += ms
        total[1] += calls
    for part, (ms, calls) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        log(f"profile {what} part: {ms:8.3f} ms {calls:6.1f} launches  "
            f"{part}")
    for ms, calls, key in rows[:40]:
        log(f"profile {what}: {ms:8.3f} ms {calls:6.1f} launches  "
            f"{key[:100]}")


def train_phase(torch, seed: int, profile: bool, cfg, name: str,
                expected: dict, accumulate: bool) -> dict:
    """A trainer over ``cfg``; ``expected`` holds the grids each kernel
    must have launched in 8 train steps and one eval step."""
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import (
        create_train_state, lr_schedule, make_eval_step, make_train_step)

    wrappers = kernel_wrappers()
    vit = cfg.image.encoder == "vit"

    def new_state(model_cfg):
        model = VqaNet(model_cfg,
                       generator=torch.Generator().manual_seed(seed))
        return create_train_state(model, INITIAL_LR)

    # The trainer's path: eight Adam steps on one batch, then an eval step.
    batch = make_batch(torch, cfg, BATCH, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = new_state(cfg)
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    reset_launches(wrappers)
    losses, scores = [], []
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, batch, gen)
        losses.append(metrics["loss"])
        scores.append(metrics["score"])
    eval_loss, eval_score = eval_step(state.model, batch)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, f"the {name} trainer's path")
    losses = [float(x) for x in losses]
    log(f"train {name} B={BATCH} bf16 dropout 0.3: losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + " | scores " + " ".join(f"{float(x):.1f}" for x in scores)
        + f" | eval loss {float(eval_loss):.4f} score "
        f"{float(eval_score):.1f}")
    log(f"train {name}: kernel launches {json.dumps(launches)}")
    require(all(np.isfinite(losses)) and bool(torch.isfinite(eval_loss)),
            "finite losses")
    require(losses[-1] < losses[0], "the loss falls on a repeated batch")
    require(all(bool(torch.isfinite(p).all())
                for p in state.model.parameters()), "finite parameters")
    require(state.step == TRAIN_STEPS, "one update per step")
    used = state.optimizer.param_groups[0]["lr"]
    require(abs(used - INITIAL_LR * 0.5 ** ((TRAIN_STEPS - 1) / 50000)) < 1e-12
            and abs(lr_schedule(INITIAL_LR)(state.step)
                    - INITIAL_LR * 0.5 ** (TRAIN_STEPS / 50000)) < 1e-12,
            "the LR follows the halving law")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on the {name} trainer's path: {launches}, "
            f"expected {expected}")

    # Kernel path against plain path at batch 8 without dropout: one train
    # step each from the same weights, then the eval step both ways.
    cfg0 = without_dropout(cfg)
    small = make_batch(torch, cfg0, 8, seed + 1)
    reference = None
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        grads = {}
        for plain in (False, True):
            state_8 = new_state(cfg0)
            make_train_step(cfg0, compute_dtype=dtype, plain_ops=plain)(
                state_8, small, gen)
            grads[plain] = {n: p.grad for n, p in
                            state_8.model.named_parameters()
                            if p.grad is not None}
        trained = [n for n, p in state_8.model.named_parameters()
                   if p.requires_grad]
        require(list(grads[False]) == trained and list(grads[True]) == trained,
                "every trained tensor has a gradient")
        if reference is None:
            reference = grads[True]  # the plain path's f32 gradients
        # The worst tensor as a share of its limit, and the tensor where
        # the kernel path lies farthest from f32 for the plain path's.
        worst, worst_ratio = ("", 0.0, 1.0), ("", 0.0, 0.0)
        listing = []
        for n, want in grads[True].items():
            require(float(want.abs().max()) > 0
                    or n == "attention.x_conv.bias",
                    f"gradient of {n} is zero")
            # The glimpse bias has gradient zero (a softmax ignores a
            # shift); what it holds is rounding noise.
            if n == "attention.x_conv.bias":
                continue
            tol = TOL["grads_" + dname]
            if dname == "bf16" and n.startswith("attention."):
                tol = TOL["grads_bf16_attention"]
            elif dname == "bf16" and vit and n.startswith("image."):
                tol = TOL["grads_bf16_vit_image"]
            rel = rel_norm(grads[False][n], want)
            if rel / tol > worst[1] / worst[2]:
                worst = (n, rel, tol)
            far_kernel = rel_norm(grads[False][n], reference[n])
            far_plain = rel_norm(want, reference[n])
            if far_plain > 0 and far_kernel / far_plain > worst_ratio[1]:
                worst_ratio = (n, far_kernel / far_plain, far_plain)
            listing.append(f"{n} {rel:.1e}" + (
                f" ({far_plain:.1e})" if dname == "bf16" else ""))
        log(f"train {name} gradients {dname} per tensor, |kernel - plain| / "
            "|plain|"
            + (" (and the plain path's distance from its f32 gradients)"
               if dname == "bf16" else "") + ": " + ", ".join(listing))
        log(f"train {name} gradients {dname} B=8 dropout 0, kernel vs plain "
            f"path: nearest its limit {worst[0]} at {worst[1]:.3e} of its "
            f"norm (tol {worst[2]:g})")
        require(worst[1] <= worst[2],
                f"kernel vs plain gradients {dname}: {worst}")
        if dname == "bf16":
            log(f"train {name} gradients bf16 against the plain path's f32 "
                f"gradients: worst tensor {worst_ratio[0]}, the kernel path "
                f"{worst_ratio[1]:.3f} times as far as the plain path "
                f"({worst_ratio[2]:.3e} of the norm; limit "
                f"{GRADS_BF16_RATIO:g} times)")
            require(worst_ratio[1] <= GRADS_BF16_RATIO,
                    f"bf16 gradients against f32: {worst_ratio}")
        results = [make_eval_step(cfg0, compute_dtype=dtype, plain_ops=plain,
                                  with_breakdown=False)(state_8.model, small)
                   for plain in (False, True)]
        (loss_k, score_k), (loss_p, score_p) = [
            (float(a), float(b)) for a, b in results]
        log(f"eval step {name} {dname} B=8: kernel path loss {loss_k:.6f} "
            f"score {score_k:.1f} | plain path loss {loss_p:.6f} score "
            f"{score_p:.1f} (loss tol {TOL['loss_' + dname]:g} relative)")
        require(abs(loss_k - loss_p) <= TOL["loss_" + dname] * abs(loss_p),
                f"kernel vs plain eval loss {dname}")
        # A sample whose two best logits lie closer than the logits'
        # tolerance may change its answer; f32 has none.
        require(abs(score_k - score_p) <= (0.0 if dname == "f32" else 1.0),
                f"kernel vs plain eval score {dname}")
    del grads, reference, state_8

    # Time and memory at batch 512, both paths.
    plain_state = new_state(cfg)
    plain_step = make_train_step(cfg, plain_ops=True)
    peaks = {}
    for path, run in (("kernel", lambda: train_step(state, batch, gen)),
                      ("plain", lambda: plain_step(plain_state, batch, gen))):
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks[path] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms, plain_ms = timed_pair(
        torch, lambda: plain_step(plain_state, batch, gen),
        lambda: train_step(state, batch, gen), iters=3, warmup=0)
    log(f"train step {name} B={BATCH} bf16: kernel path {ms:.3f} ms = "
        f"{BATCH / ms * 1e3:.1f} samples/s, peak memory "
        f"{peaks['kernel']:.2f} GiB | plain path {plain_ms:.3f} ms = "
        f"{BATCH / plain_ms * 1e3:.1f} samples/s, peak memory "
        f"{peaks['plain']:.2f} GiB")
    del plain_state

    if accumulate:
        accum_step = make_train_step(cfg, accum_steps=4)
        before = state.step
        torch.cuda.reset_peak_memory_stats()
        accum_ms = timed(
            torch,
            lambda: losses.append(accum_step(state, batch, gen)[1]["loss"]),
            iters=3, warmup=1)
        require(state.step == before + 4 and all(
            bool(torch.isfinite(x)) for x in losses[-4:]),
            "four accumulated steps")
        log(f"train step {name} B={BATCH} bf16 accum_steps=4: {accum_ms:.3f} "
            f"ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, loss "
            f"{float(losses[-1]):.4f}")
    if profile:
        profile_steps(torch, lambda: train_step(state, batch, gen), ms,
                      f"{name} train step")
        with torch.no_grad():
            forward_ms = timed(torch, lambda: eval_step(state.model, batch),
                               iters=3)
            profile_steps(torch, lambda: eval_step(state.model, batch),
                          forward_ms, f"{name} eval step")
    return launches


def fused_train_phase(torch, seed: int, cfg, expected: dict) -> dict:
    """One train step of ``cfg`` at batch 512 with ``fused_ops=True``
    (kernel 6 forward for the blocks it takes, the conv computed again and
    kernel C in their backward; the forward-only ops stay off), its loss
    and gradients against the ``fused_ops=False`` step at batch 8, then its
    time and peak memory with the flip on and off."""
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import create_train_state, make_train_step

    wrappers = kernel_wrappers()

    def new_state(model_cfg):
        model = VqaNet(model_cfg,
                       generator=torch.Generator().manual_seed(seed))
        return create_train_state(model, INITIAL_LR)

    batch = make_batch(torch, cfg, BATCH, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    steps = {flip: make_train_step(cfg, fused_ops=flip)
             for flip in (True, False)}
    states = {flip: new_state(cfg) for flip in (True, False)}
    reset_launches(wrappers)
    _, metrics = steps[True](states[True], batch, gen)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, "the fused_ops train step")
    log(f"train cnn fused_ops B={BATCH} bf16 dropout 0.3: loss "
        f"{float(metrics['loss']):.4f} | kernel launches "
        f"{json.dumps(launches)}")
    require(bool(torch.isfinite(metrics["loss"])), "finite loss")
    require(all(bool(torch.isfinite(p).all())
                for p in states[True].model.parameters()),
            "finite parameters")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches of the fused_ops train step: {launches}, "
            f"expected {expected}")

    cfg0 = without_dropout(cfg)
    small = make_batch(torch, cfg0, 8, seed + 1)
    reference = None
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        grads, losses = {}, {}
        for flip in (True, False):
            state_8 = new_state(cfg0)
            _, metrics = make_train_step(
                cfg0, compute_dtype=dtype, fused_ops=flip)(state_8, small, gen)
            losses[flip] = float(metrics["loss"])
            grads[flip] = {n: p.grad for n, p in
                           state_8.model.named_parameters()
                           if p.grad is not None}
        require(list(grads[True]) == list(grads[False]),
                "the same tensors have gradients")
        if reference is None:
            reference = grads[False]  # the unfused step's f32 gradients
        worst, worst_ratio, listing = ("", 0.0, 1.0), ("", 0.0, 0.0), []
        for n, want in grads[False].items():
            if n == "attention.x_conv.bias":  # gradient zero: rounding noise
                continue
            attention = n.startswith("attention.")
            if dname == "f32":
                tol = TOL["grads_f32_fused_attention" if attention
                          else "grads_f32"]
            else:
                tol = TOL["grads_bf16_fused_attention" if attention
                          else "grads_bf16_fused"]
            rel = rel_norm(grads[True][n], want)
            listing.append(f"{n} {rel:.1e}")
            if rel / tol > worst[1] / worst[2]:
                worst = (n, rel, tol)
            far_on = rel_norm(grads[True][n], reference[n])
            far_off = rel_norm(want, reference[n])
            if far_off > 0 and far_on / far_off > worst_ratio[1]:
                worst_ratio = (n, far_on / far_off, far_off)
        log(f"train cnn fused_ops gradients {dname} B=8 dropout 0, |on - "
            "off| / |off| per tensor: " + ", ".join(listing))
        log(f"train cnn fused_ops {dname} B=8: loss on {losses[True]:.6f}, "
            f"off {losses[False]:.6f} (tol {TOL['loss_' + dname]:g} "
            f"relative); nearest its limit {worst[0]} at {worst[1]:.3e} of "
            f"its norm (tol {worst[2]:g})")
        require(abs(losses[True] - losses[False])
                <= TOL["loss_" + dname] * abs(losses[False]),
                f"fused_ops on vs off loss {dname}")
        require(worst[1] <= worst[2],
                f"fused_ops on vs off gradients {dname}: {worst}")
        if dname == "bf16":
            log(f"train cnn fused_ops gradients bf16 against the unfused "
                f"step's f32 gradients: worst tensor {worst_ratio[0]}, "
                f"fused_ops on {worst_ratio[1]:.3f} times as far as off "
                f"({worst_ratio[2]:.3e} of the norm; limit "
                f"{GRADS_BF16_RATIO:g} times)")
            require(worst_ratio[1] <= GRADS_BF16_RATIO,
                    f"fused_ops bf16 gradients against f32: {worst_ratio}")
    del grads, reference, state_8

    peaks = {}
    for flip in (True, False):
        steps[flip](states[flip], batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps[flip](states[flip], batch, gen)
        torch.cuda.synchronize()
        peaks[flip] = torch.cuda.max_memory_allocated() / 2 ** 30
    ms, off_ms = timed_pair(
        torch, lambda: steps[False](states[False], batch, gen),
        lambda: steps[True](states[True], batch, gen), iters=3, warmup=0)
    log(f"train step cnn B={BATCH} bf16, kernel path: fused_ops on {ms:.3f} "
        f"ms = {BATCH / ms * 1e3:.1f} samples/s, peak memory "
        f"{peaks[True]:.2f} GiB | off {off_ms:.3f} ms = "
        f"{BATCH / off_ms * 1e3:.1f} samples/s, peak memory "
        f"{peaks[False]:.2f} GiB")
    return launches


def fused_eval_phase(torch, seed: int, cfg, name: str, expected: dict) -> dict:
    """One eval step of ``cfg`` at batch 512 with ``fused_ops=True`` (under
    its ``no_grad`` the forward-only ops are on as well: the stem, the LN +
    MLP), then its loss and score against the ``fused_ops=False`` step's at
    batch 8 in f32 and bf16."""
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import make_eval_step

    wrappers = kernel_wrappers()
    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    batch = make_batch(torch, cfg, BATCH, seed)
    reset_launches(wrappers)
    loss, score = make_eval_step(cfg, fused_ops=True)(model, batch)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, f"the {name} fused_ops eval step")
    log(f"eval step {name} fused_ops B={BATCH} bf16: loss {float(loss):.4f} "
        f"score {float(score):.1f} | kernel launches {json.dumps(launches)}")
    require(bool(torch.isfinite(loss)) and bool(torch.isfinite(score)),
            "finite eval loss and score")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches of the {name} fused_ops eval step: {launches}, "
            f"expected {expected}")

    small = make_batch(torch, cfg, 8, seed + 1)
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        (loss_on, score_on), (loss_off, score_off) = [
            tuple(map(float, make_eval_step(
                cfg, compute_dtype=dtype, fused_ops=flip)(model, small)))
            for flip in (True, False)]
        log(f"eval step {name} {dname} B=8: fused_ops on loss {loss_on:.6f} "
            f"score {score_on:.1f} | off loss {loss_off:.6f} score "
            f"{score_off:.1f} (loss tol {TOL['loss_' + dname]:g} relative)")
        require(abs(loss_on - loss_off)
                <= TOL["loss_" + dname] * abs(loss_off),
                f"fused_ops on vs off eval loss {dname}")
        # As between the kernel and the plain path: a near tie between a
        # sample's two best logits may change its answer in bf16.
        require(abs(score_on - score_off) <= (0.0 if dname == "f32" else 1.0),
                f"fused_ops on vs off eval score {dname}")
    return launches


def layout_probe_phase(torch, seed: int) -> dict:
    """The probe's path: its eight cases (four re-layouts of a
    ``[16, 32, C]`` bf16 block, C = 64 and 128) through the dispatch a
    caller uses, in one launch, each held to its plain version to the
    bit."""
    from dl_vqa_tpu_torch.ops.layout_cases import layout_cases

    wrappers = kernel_wrappers()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs, modes = layout_inputs(torch, gen)
    reset_launches(wrappers)
    outs = layout_cases(xs, modes)
    launches = read_launches(wrappers, "the layout probe")
    check_layout(torch, xs, modes, outs)
    log(f"layout probe: 8 cases equal to the bit, kernel launches "
        f"{json.dumps(launches)}")
    require(launches == {**dict.fromkeys(wrappers, 0), "layout_cases": 1},
            f"kernel launches of the layout probe: {launches}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel over two "
                             "train steps")
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

    from dl_vqa_tpu_torch.models.configs import ModelConfig

    # Grids a kernel launches on each path. Serving: one forward of the 8
    # requests. Training: 8 train steps and one eval step; per train step
    # one recurrence (kernel A) and 23 backward grids, one glimpse pooling,
    # and for the CNN three pool blocks forward (a grid each) and backward
    # (two grids each: the routing, then the sum of its partial bias sums),
    # for the ViT four attention cores forward and backward (a grid each; in
    # bf16 the backward's block runs over a head's query rows for dq, then
    # over its key rows for dk and dv); the eval step adds kernel 1 and a
    # forward's grids. A recurrence (kernel 1 or A) in bf16 is one
    # persistent launch (required on an H100 SXM, see recurrence_grids).
    recurrence = recurrence_grids(torch)
    log(f"lstm recurrence: {recurrence} grid(s) a call in bf16")
    lstm_training = {"lstm_recurrence": recurrence,
                     "lstm_recurrence_save": TRAIN_STEPS * recurrence,
                     "lstm_backward_step": TRAIN_STEPS * SEQ_LEN,
                     "attention_pool": TRAIN_STEPS + 1}
    vit_layers = vit_config().image.num_layers
    # A forward with the flip on and gradients off, served or evaluated.
    cnn_fused_forward = {"lstm_recurrence": recurrence,
                         "conv_relu_pool_stem": 1,
                         "conv_relu_pool_fused": 2, "attention_pool": 1}
    vit_fused_forward = {"lstm_recurrence": recurrence, "attention_pool": 1,
                         "vit_attention": vit_layers,
                         "vit_mlp_fused": 2 * vit_layers}
    paths = {
        "cnn_serving": slice_phase(
            torch, args.seed, ModelConfig(), "cnn",
            {"lstm_recurrence": recurrence, "relu_maxpool": 3,
             "attention_pool": 1}),
        "cnn_training": train_phase(
            torch, args.seed, args.profile, ModelConfig(), "cnn",
            {**lstm_training, "relu_maxpool": 3 * (TRAIN_STEPS + 1),
             "relu_maxpool_backward": 6 * TRAIN_STEPS}, accumulate=True),
        "vit_serving": slice_phase(
            torch, args.seed, vit_config(), "vit",
            {"lstm_recurrence": recurrence, "attention_pool": 1,
             "vit_attention": vit_layers}),
        "vit_training": train_phase(
            torch, args.seed, args.profile, vit_config(), "vit",
            {**lstm_training, "vit_attention": vit_layers * (TRAIN_STEPS + 1),
             "vit_attention_backward": vit_layers * TRAIN_STEPS},
            accumulate=False),
        # The flip: the stem and two conv blocks in place of three pool
        # grids; a fused LN + MLP a ViT layer beside its attention core (two
        # grids in bf16: the weights' packing, then the block); a
        # train step keeps block 0 and every backward on the unfused path.
        "cnn_fused_serving": slice_phase(
            torch, args.seed, ModelConfig(), "cnn", cnn_fused_forward,
            fused=True, profile=args.profile),
        "vit_fused_serving": slice_phase(
            torch, args.seed, vit_config(), "vit", vit_fused_forward,
            fused=True, profile=args.profile),
        "cnn_fused_eval": fused_eval_phase(
            torch, args.seed, ModelConfig(), "cnn", cnn_fused_forward),
        "vit_fused_eval": fused_eval_phase(
            torch, args.seed, vit_config(), "vit", vit_fused_forward),
        "cnn_fused_training": fused_train_phase(
            torch, args.seed, ModelConfig(),
            {"lstm_recurrence_save": recurrence,
             "lstm_backward_step": SEQ_LEN,
             "attention_pool": 1, "relu_maxpool": 1,
             "relu_maxpool_backward": 6, "conv_relu_pool_fused": 2}),
        "layout_probe": layout_probe_phase(torch, args.seed),
    }
    log(f"total {time.perf_counter() - start:.1f} s")

    csrc = "dl_vqa_tpu_torch/csrc/"
    sources = {
        "lstm_recurrence": ("lstm_recurrence.cu",
                            "dl_vqa_tpu/ops/lstm_pallas.py:139"),
        "lstm_recurrence_save": ("lstm_recurrence.cu",
                                 "dl_vqa_tpu/ops/lstm_pallas.py:177"),
        "lstm_backward_step": ("lstm_backward.cu",
                               "dl_vqa_tpu/ops/lstm_pallas.py:88"),
        "relu_maxpool": ("relu_maxpool.cu",
                         "dl_vqa_tpu/ops/conv_fused.py:375"),
        "relu_maxpool_backward": ("relu_maxpool_backward.cu",
                                  "dl_vqa_tpu/ops/conv_fused.py:693"),
        "attention_pool": ("attention_pool.cu",
                           "dl_vqa_tpu/ops/attention_pool.py:36"),
        "vit_attention": ("vit_attention.cu",
                          "dl_vqa_tpu/ops/vit_attention_pallas.py:78"),
        "vit_attention_backward": (
            "vit_attention_backward.cu",
            "dl_vqa_tpu/ops/vit_attention_pallas.py:127"),
        "conv_relu_pool_fused": ("conv_relu_pool_fused.cu",
                                 "dl_vqa_tpu/ops/conv_fused.py:205"),
        "conv_relu_pool_stem": ("conv_relu_pool_stem.cu",
                                "dl_vqa_tpu/ops/conv_fused.py:471"),
        "vit_mlp_fused": ("vit_mlp_fused.cu",
                          "experiments/probe_vit_mlp_fused.py:57"),
        "layout_cases": ("layout_cases.cu",
                         "experiments/probe_mosaic_recheck.py:58"),
    }
    # The tensor-core instruction of the fused-path kernels in bf16.
    mma = {"conv_relu_pool_fused": "wgmma", "vit_mlp_fused": "wgmma",
           "conv_relu_pool_stem": "mma.sync"}
    # launches: the grids of all paths together, each path counted from 0:
    # serving is 8 requests, training 8 train steps and an eval step, the
    # fused_ops train and eval paths one step each, the layout probe its
    # eight cases in one launch.
    kernels = [
        {"name": name, "route": "cuda", "source": csrc + src,
         "replaces": replaces, **({"mma": mma[name]} if name in mma else {}),
         "launches": sum(counts[name] for counts in paths.values()),
         **{f"launches_{path}": counts[name]
            for path, counts in paths.items()},
         # read_launches held every path's grids to the fast path's count.
         **({FAST_PATHS[name]: sum(counts[name]
                                   for counts in paths.values())}
            if name in FAST_PATHS else {}), **summary[name]}
        for name, (src, replaces) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
