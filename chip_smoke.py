#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dl_vqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile] [--parent-lstm DIR]

1. device: the card's name and power limit, torch / CUDA / nvcc versions;
2. build: compiles the port's CUDA kernels from dl_vqa_tpu_torch/csrc;
3. kernels: each of the sixteen kernels against its plain PyTorch version on
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
   (``checked_ms``), beside the whole backward with its products; kernels
   1 and A in f32 and the f32 token states at B = 1, 8, 64 and 512, each
   one launch of the f32 persistent kernel, beside cuDNN's f32 LSTM (TF32
   off, the input GEMM included), the token states' h, c and h_all kernel
   A's f32 bits; kernel 9's eight cases one by one and in one launch;
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
8. the layout probe's eight cases through their dispatch, in one launch;
9. cnn_e2e: the train and eval journey through the port's entry points. A
   corpus of 4,096 train and 1,024 val questions over 512 and 128 images at
   224 px, rendered by ``dl_vqa_tpu_torch.data.synthetic`` into an ``.npy``
   store under ``_smoke_e2e/``, its questions widened to the reference's
   15,193 ids and 23 tokens; ``dl_vqa_tpu_torch.main.main`` trains the
   reference-parity model on it (``config`` preset, batch 512, bf16,
   dropout 0.3, 2 epochs, the device image table on, a rolling checkpoint
   every 3 batches); a second run's batcher raises at batch 5 of epoch 1,
   and a third run resumed from its ``last.ckpt`` must end with the first
   run's state (cuDNN deterministic for these runs); ``evaluate_vqa`` on
   the first run's best ``model.ckpt`` must give its best score. Then, not
   counted: from the first run's final state, a train step and an eval
   step on the corpus's batches with the kernels held to the plain path;
   the bare train step's time; and ``main`` again with the table on and
   off under ``torch.profiler``, for the epoch's seconds and samples/s
   through the loop and the device's idle share over the epoch: one JSON
   line ``{"cnn_e2e": ...}``;
10. the quantized serving modes (before phase 9, their evaluations after
   it): kernel 2's e4m3 and int8 modes and kernel D (the W8A8 conv block:
   its wgmma kernel at the model's shapes, B = 512 and the serving
   buckets, beside the bf16 block; its mma.sync kernel at stride 2) join
   phase 3, with tolerance 0 in bits and codes (NaN positions included,
   and the e4m3 overflow edge at 464); every int8 CNN path must launch D's
   wgmma kernel only (``FAST_PATHS``); a Predictor serves the
   requests in each mode (the CNN with the f8 store, the CNN's int8 stem
   and the ViT's int8 products, both calibrated by
   ``Predictor.calibrate_int8``), its logits held to the plain path's, the
   batch-512 forward and the forward at B = 1, 8 and 64 timed in turns
   with the compute mode; one f8 train step, its gradients held to the
   plain path's at batch 8; and ``evaluate_vqa`` in f8 and int8
   (calibrated on the train store) on phase 9's best checkpoint: one JSON
   line ``{"quant": ...}``;
11. the serving front: the reference-parity model's random weights from
   the seed saved as an npz checkpoint under ``_smoke_serving/`` with a
   vocab.json of 15,193 ids and 3,000 answers. The port's decoder on this
   host (libjpeg, or nvJPEG where the host has none) against PIL's pixels
   of the committed fixtures (``dl_vqa_tpu_torch/tools/fixtures``);
   ``serving_http``: ``serve.build_server`` (max_batch 64, window 5 ms)
   answers the fixtures posted at once, each answer held to the
   Predictor's forward of the same pixels, then closed-loop clients (a
   process of their own) posting the COCO-sized fixture (640x480, 62 KB)
   at concurrency 1, 8 and 64, client and server
   p50/p99, QA/s and mean batch, kernels 1, 2 and 3 launched 1, 3 and 1
   times a served batch; ``Predictor.forward_probs`` alone at B = 1, 8,
   64; an int8 server calibrated on the fixtures (kernel D twice a batch);
   ``serving_native``: the same through ``serve.build_native_server``,
   its answers held to the Python front's, or, on a host with no libjpeg,
   its refusal to build naming ``jpeglib.h``; ``python -m
   dl_vqa_tpu_torch.serve --port 0`` (and ``--native-front``) as a process
   of its own, its answers held to the Predictor's; ``submission`` (after
   phase 9): ``python -m dl_vqa_tpu_torch.predict --submission`` as a
   subprocess on cnn_e2e's corpus and best checkpoint, table on and off,
   the two files equal and each answer the eval forward's argmax: one
   JSON line ``{"serving": ...}``;
12. aot (after phase 11's fronts): the serving checkpoint exported by
   ``python -m dl_vqa_tpu_torch.predict --export-artifact`` at B = 1, 8,
   64 (``utils/aot_export.py``: one ``torch.export`` program a bucket, the
   hand kernels as ``vqa::`` custom ops, the weights as arguments); a
   process of its own (``--aot-client``) that imports none of the model
   code loads it, answers B = 1, 8, 64, 13 (padded) and 77 (split), its
   logits the live Predictor's on the same blocks to the bit, kernels 1,
   2, 3 launched 1, 3, 1 times a bucket call; the artifact's forward
   against the Predictor's in turns; exports at B = 8 of the ViT and the
   CNN with ``fused_ops``, the f8 store and the calibrated int8 stem, held
   likewise, so that every serving op launches from an exported program;
   ``torch.library.opcheck`` of every ``vqa::`` op at a small and its
   serving shape, and each op's dispatch cost at B = 1 against its
   wrapper called directly: one JSON line ``{"aot": ...}``;
13. sweep (after phase 9): ``dl_vqa_tpu_torch.main.multirun_main`` over
   two learning rates on cnn_e2e's corpus, one epoch a trial, the table
   on; each trial launches kernels 1, A, B, 2, C and 3 as its steps ask,
   and the best returned is the larger trial's: one JSON line ``{"sweep":
   ...}``;
14. variants (after phase 12, its journey after phase 13): the presets
   ``config_san`` (bi-LSTM, stacked attention, 3,000 answers) and
   ``config_transformer_co`` (the transformer question encoder, 2 layers
   of 8 heads of 128, co-attention, 10,000 answers) at full width, built
   from the port's preset dicts (``variant_config``), each through phases
   4 and 5 (8 requests, the logits held to the plain path, the batch-512
   forward timed; VARIANT_STEPS train steps at batch 512, the gradients
   held to the plain path's at batch 8, the step timed) and exported at
   B = 8, the program's logits the live Predictor's to the bit; a served
   batch launches kernel 1 once, kernel 2 three times and kernel 3 twice
   for SAN, kernel 2 three times and kernel 3 once for transformer_co
   (no LSTM); then (lstm, co), which no preset has, at batch 8: served and a
   train step each way, its per-token states in f32 on the f32 persistent
   kernel (``lstm_token_states``, its token store mode serving and kernel
   A's f32 mode training, one grid a call), and its forward and train step
   timed at batch 512 (with ``--parent-lstm DIR`` also on the LSTM kernels
   of another version's files, in turns); after phase 9, ``main`` trains
   ``config_transformer_co`` for one epoch on cnn_e2e's corpus and
   ``evaluate_vqa`` on its best checkpoint gives its best score: one JSON
   line ``{"variants": ...}``;
15. vit_moe (after phase 14's presets): ``config_vit_moe`` (the ViT of
   phase 6 with every block's MLP a mixture of 8 experts of width 1,024,
   top-2, capacity factor 1.25), built from the port's preset dicts, at
   full width through phases 4 and 5 (8 requests, the logits held to the
   plain path with the share of routes that the two paths send to other
   experts, a request with such a flipped route to its own tolerance; the
   batch-512 forward timed; MOE_STEPS train steps at batch 512 with their
   ``moe_aux``, the gradients held to the plain path's at batch 8, the
   step timed), served with ``fused_ops`` (no kernel 8 grid, the unfused
   path's bits) and exported at B = 8, the program's logits the live
   Predictor's to the bit: one JSON line ``{"vit_moe": ...}``. Phase 3
   also holds kernels 4 and 5 at two heads of 128 (B = 512, S = 196, bf16
   and f32) to their plain versions and times them beside SDPA
   (``head128`` in the kernels line);
16. online_e2e (after phase 9): the image data plane from JPEG files.
   cnn_e2e's questions over COCO-named copies of the committed fixtures
   (mostly the 640x480 one) in a JPEG directory a split; both stores
   built by ``preprocess_images(backend="auto")`` (nvJPEG on a host with
   no libjpeg; an ``.npy`` store where h5py is missing), every row held
   to PIL's pixels of its fixture within TOL["decode_nvjpeg"] levels; the
   loader's images/s at 640x480 -> 224 with 1, 4, 8 and all the host's
   threads; ``main`` for 2 epochs with ``tpu.online_images=true`` and
   ``tpu.profile_dir`` (the trace of epoch 1 parsed: the step's kernels,
   the epoch's samples/s and the device's idle share), ``evaluate_vqa``
   online on its best checkpoint, then in f32 online and from the built
   store (the scores to TOL["online_eval_score"]); two runs of 2 epochs
   from the built store with and without ``tpu.debug_nans`` (no alarm;
   the step time of each): one JSON line ``{"online_e2e": ...}``.

Every path (CNN serving, CNN training, ViT serving, ViT training, then CNN
and ViT serving, CNN and ViT evaluation and CNN training with the flip on,
the layout probe, the three quantized serving paths and the f8 train step,
the serving front's HTTP, int8 HTTP and native paths, the exported
programs of the aot phase, the variants' serving, training and exported
paths, the ViT-MoE's serving, fused serving, training and exported
paths, cnn_e2e, online_e2e's run and evaluation, cnn_e2e's quantized
evaluations, the sweep's trials and the transformer_co journey) is driven with the kernels'
launch counts set to 0 just before it and read just after; on every path
kernels C and B run their vector kernels, kernel 7 its tensor-core
kernel and the token states the f32 persistent kernel (``FAST_PATHS``).
Then
one JSON line with every kernel's launches (grids launched in those runs;
the LSTM recurrence one a call in bf16 and in f32, the LSTM backward one
per timestep, the pool backward two per call),
error, times and bound, and as the last line ``{"ok": true, "device":
{...}}``. Every time printed was taken on the
card whose name and power limit the first line gives.
Any failed check raises and the exit code is nonzero; without CUDA it
exits nonzero at once. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
#  gradients of (lstm, co) in bf16, kernel path against plain path at
#    batch 8: 5e-2 on every tensor. Its token states are f32 on both paths
#    (kernel A's f32 mode against the plain recurrence, 1e-7 apart), and
#    co-attention rounds them to bf16 for its token products, so such a
#    difference flips a token's rounding now and then; q_attended, which
#    the classifier reads, moves by bf16 steps, and that reaches every
#    tensor's gradient through the loss (H100: 7.8e-3 to 9.6e-3 on every
#    tensor, where the plain path lies 2.4e-2 to 4.1e-2 from its f32
#    gradients). The ratio to the plain path's distance from f32 holds as
#    everywhere.
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
#  e2e_resume: 0, every array of the final train state (parameters, Adam
#    moments and counts, step) and the best score: the resumed run restores
#    f32 arrays exactly, re-derives the epoch's order from (seed, epoch) and
#    each step's dropout masks from (seed, step), and with cuDNN set
#    deterministic for the phase every op of a step gives the same bits on
#    the same inputs (the kernels have no atomics; the embedding's
#    gradient sums duplicates in sorted order; gather's backward adds only
#    zeros to a slot that another answer also reaches).
#  e2e_eval_score: 1e-3 percent points: evaluate_vqa rounds to 3 decimals
#    (5e-4) and scores the same weights with the same eval step and batches
#    as the loop did; one sample answered otherwise moves the score by at
#    least 0.3 / 1024 * 100 = 0.029.
#  relu_maxpool_e4m3, relu_maxpool_int8: 0, in bits (NaN at the same
#    places) and in codes: kernel 2 takes the max first and applies the
#    bias, ReLU and the cast to e4m3 (one rounding, NaN above 464) or the
#    scale, rint and clip after it; all are non-decreasing, so the bits are
#    the plain version's, which applies them first.
#  conv_relu_pool_int8: 0 in codes: kernel D's s32 sums are exact, as the
#    plain version's float64 ones, and its epilogue is one fused
#    multiply-add (__fmaf_rn), as the plain version's float64 emulation.
#  logits of the quantized serving paths, kernel path against plain path:
#    the e4m3 bits and int8 codes are equal on both paths, so as the other
#    logits (logits_bf16, logits_f32); the ViT's int8 sites quantize values
#    that kernel 4's bf16 roundings may move by a step, which moves a code
#    by at most one: logits_bf16 still. In f32 kernel 4 sums in another
#    order than the plain attention, and an input a last place away from
#    a code's rounding edge flips that code, which moves its product by
#    one code step (1/127 of the site's amax times a weight): the logits
#    by about 1e-5 (H100: 1.3e-5), so logits_f32_int8_vit is 1e-4.
#  quant_eval_pp: evaluate_vqa in f8 and int8 on cnn_e2e's best checkpoint
#    within 3 percentage points of the loop's best (compute) score: the
#    modes move a few answers of 1,024 questions (each answer 0.1 pp or
#    less), and a broken mode answers at chance (the JAX package's deltas
#    were -0.018 and +0.007 pp on its hard task).
#  decode_libjpeg: 1 uint8 level against PIL's pixels of the committed
#    fixtures (tools/fixtures/expected.npz): the same libjpeg decode, PIL's
#    resize in fixed point where the native code resizes in float.
#  decode_nvjpeg: 4 levels on every fixture. The decoder of a host with no
#    libjpeg takes nvJPEG's planes and upsamples and converts them as
#    libjpeg does (csrc/host/ycc.cc, equal to libjpeg's RGB on libjpeg's
#    planes in the CPU tests), so only nvJPEG's inverse DCT differs from
#    libjpeg's, by a level or two an element (nvJPEG's own RGB output,
#    which upsamples chroma otherwise, was within 3 levels on the 4:4:4
#    and greyscale fixtures on the H100 host and 64 off at 4:2:2 chroma
#    edges). A swapped channel or a crop a pixel off moves tens of levels.
#  aot_logits: an exported program's logits against the live
#    Predictor's on the same (padded) batch: the program calls the same
#    vqa:: ops and the same ATen ops on the same shapes, so the same bits.
#  logits_moe_flipped, grads_moe_flipped: the ViT-MoE held to its plain
#    path. Routing is an argmax over f32 router probabilities, so where
#    kernel 4's bf16 roundings (or, rarely, the f32 sums' order) move a
#    near-tie, a token takes another expert on one path than on the other
#    (a flipped route). A request none of whose routes flipped is held to
#    logits_bf16 / logits_f32 as the dense models are; one with a flipped
#    route to 2e-3: the flip swaps one token's output of one expert for
#    another's in one of 196 tokens, which the pooling over the grid
#    divides before the classifier (H100: 0.29% of the routes flipped in
#    bf16, 7 of 8 requests, logits 1.3e-4 apart; none in f32). Gradients at
#    batch 8: where no route flipped, the dense tolerances; where one did,
#    at least 1.5e-1 of each tensor's norm, as the bf16 attention's 1e-1
#    and a flip's share more: a flip moves a token's share between two
#    experts' weights and the router's gradient, of a few hundred tokens
#    each (H100: 0.20% flipped, attention.q_lin.bias 8.7e-2, the MoE
#    tensors 2.3e-2 at most). The share of flipped routes is printed
#    beside each comparison.
#  served_probs: a served probability against the Predictor's forward of
#    the same pixels and question, relative. A served batch pads to its
#    bucket, and cuDNN may choose another algorithm at another batch size,
#    so the logits may move as the kernel and plain paths' may
#    (logits_bf16, 5e-4) and a probability by a factor within exp(+-2 *
#    5e-4): 1e-3. Answers must agree at every rank where the reference's
#    neighbouring probabilities differ from it by more than that.
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
       "grads_bf16_attention": 1e-1, "grads_bf16_lstm_co": 5e-2,
       "loss_f32": 1e-5, "loss_bf16": 5e-4,
       "e2e_resume": 0.0, "e2e_eval_score": 1e-3,
       "relu_maxpool_e4m3": 0.0, "relu_maxpool_int8": 0.0,
       "conv_relu_pool_int8": 0.0, "quant_eval_pp": 3.0,
       "logits_f32_int8_vit": 1e-4, "decode_libjpeg": 1,
       "decode_nvjpeg": 4,
       "served_probs": 1e-3, "aot_logits": 0.0,
       "logits_moe_flipped": 2e-3, "grads_moe_flipped": 1.5e-1,
       "online_eval_score": 1e-6, "online_eval_loss": 1e-3}
# Published peaks of an H100 SXM at its full 700 W: device memory rate,
# dense bf16 tensor-core rate, f32 rate outside the tensor cores, dense
# int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
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


class RecordedRoutes:
    """While active, every MoE layer's ``expert [G, S, K]`` as the forwards
    inside route them, in order (``dl_vqa_tpu_torch.ops.moe``'s gating,
    wrapped)."""

    def __enter__(self):
        from dl_vqa_tpu_torch.ops import moe

        self.module, self.gating, self.routes = moe, moe.top_k_gating, []

        def recording(logits, top_k, capacity):
            routing = self.gating(logits, top_k, capacity)
            self.routes.append(routing.expert)
            return routing

        moe.top_k_gating = recording
        return self.routes

    def __exit__(self, *exc):
        self.module.top_k_gating = self.gating


def route_flips(a: list, b: list):
    """``(share, rows)``: the share of ``(layer, token, slot)`` routes that
    differ between two runs' recorded routes, and for each group (image)
    whether any of its routes differ (``None`` when neither run routed)."""
    if not a and not b:
        return 0.0, None
    require(len(a) == len(b) and all(x.shape == y.shape
                                     for x, y in zip(a, b)),
            "both runs route the same layers")
    differ = sum(int((x != y).sum()) for x, y in zip(a, b))
    total = sum(x.numel() for x in a)
    rows = sum((x != y).flatten(1).any(1).long().cpu() for x, y in zip(a, b))
    return differ / total, (rows > 0).numpy()


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


def f32_grids(torch) -> int:
    """Grids one f32 call of kernel 1, kernel A or the token states
    launches at D = 2, H = 1024: one launch of the f32 persistent kernel
    where ``f32_plan`` has room, else one a timestep. A card of 128 SMs or
    more (an H100 SXM has 132) must have the plan."""
    from dl_vqa_tpu_torch.ops.lstm_cuda import f32_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = f32_plan(2, HIDDEN, sms)
    require(plan is not None or sms < 128,
            f"no f32 plan for D=2, H={HIDDEN} on {sms} SMs")
    return SEQ_LEN if plan is None else 1


def lstm_library_ms(torch, gen, device, lengths, train: bool,
                    dtype=None) -> float:
    """ms of one ``nn.LSTM(bidirectional=True)`` forward (cuDNN) on a
    PackedSequence of ``lengths``, packed before the timing: kernel 1's
    yardstick in eval mode, kernel A's in train mode (which keeps what the
    backward needs). It also does the input GEMM, which kernels 1 and A
    leave outside. In fp16, which has bf16's bytes and operations: PyTorch
    flattens no bf16 weights for cuDNN, so a bf16 module repacks them on
    every call (and its time swings with that). ``dtype=torch.float32``
    times it in f32 instead (TF32 off), the yardstick of the token
    states' f32 mode."""
    from torch.nn.utils.rnn import pack_padded_sequence

    dtype = dtype or torch.float16
    lstm = torch.nn.LSTM(EMBED, HIDDEN, batch_first=True,
                         bidirectional=True).to(device, dtype)
    lstm.flatten_parameters()
    lstm.train(train)
    x = torch.tanh(torch.randn(len(lengths), SEQ_LEN, EMBED, generator=gen,
                               device=device)).to(dtype)
    packed = pack_padded_sequence(x, lengths.cpu(), batch_first=True,
                                  enforce_sorted=False)
    with torch.set_grad_enabled(train):
        return timed(torch, lambda: lstm(packed), iters=10)


def lstm_kernels(torch, gen, device, summary) -> None:
    """Kernel 1, its save mode (kernel A), the token states (kernel A's
    f32 store mode) and the backward step (kernel B) at T=23, H=1024, two
    directions; kernels 1 and A in bf16 and f32, each beside cuDNN's
    ``nn.LSTM`` (fp16 for bf16, f32 with TF32 off for f32)."""
    from dl_vqa_tpu_torch.ops.lstm import (
        lstm_backward_step_reference, lstm_recurrence_reference,
        lstm_recurrence_save_reference, lstm_saved_state_backward,
        lstm_token_states_reference)
    from dl_vqa_tpu_torch.ops.lstm_cuda import (
        lstm_backward_step_cuda, lstm_backward_step_launcher,
        lstm_recurrence_cuda, lstm_recurrence_save_cuda,
        lstm_token_states_cuda)

    def report(name, dtype, batch, err, tol, ms, plain_ms, extra=""):
        log(f"kernel {name} {str(dtype)[6:]} B={batch} T={SEQ_LEN} "
            f"H={HIDDEN}: max_abs_err {err:.3e} (tol {tol:g}) | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms{extra}")
        require(err <= tol, f"{name} {dtype} B={batch}: {err} > {tol}")

    # bf16 entries by batch, and f32 entries (kernels 1, A and the token
    # states on the f32 persistent kernel) by batch.
    by_batch = {"lstm_recurrence": {}, "lstm_recurrence_save": {}}
    by_batch_f32 = {"lstm_recurrence": {}, "lstm_recurrence_save": {},
                    "lstm_token_states": {}}
    f32 = f32_grids(torch)

    def launched(fn, call):
        """``call()`` and the grids ``fn`` counted for it: (all, on the
        f32 persistent kernel)."""
        before = fn.launches, fn.launches_f32_persistent
        out = call()
        return out, (fn.launches - before[0],
                     fn.launches_f32_persistent - before[1])

    for dtype, tol in ((torch.bfloat16, TOL["lstm_bf16"]),
                       (torch.float32, TOL["lstm_f32"])):
        main = dtype == torch.bfloat16
        # 1, 8 and 64 are serving buckets of serve.py, 512 the batch of the
        # paths below.
        for batch in (1, 8, 64, BATCH):
            iters = 10 if batch == BATCH else 20
            x_proj, w_hh, lengths, master = lstm_inputs(
                torch, gen, batch, dtype, device)
            args = (x_proj, w_hh, lengths)
            # Steps that the data needs: padded ones change nothing. Kernel
            # A also writes a padded step's gates, a product of its own.
            steps = int(lengths.sum()) * x_proj.shape[0]
            product_ops = 2.0 * steps * 4 * HIDDEN * HIDDEN
            save_ops = 2.0 * x_proj.shape[:3].numel() * 4 * HIDDEN * HIDDEN
            kind = "bf16" if main else "f32"
            # In bf16 the call is the persistent kernel where the card has
            # a plan, not the per-step grids; in f32 the f32 persistent
            # kernel (one launch, counted on its own).
            want = ((recurrence_grids(torch), 0) if main
                    else (f32, 1 if f32 == 1 else 0))
            library = lstm_library_ms(torch, gen, device, lengths,
                                      train=False,
                                      dtype=None if main else torch.float32)
            yardstick = "fp16 nn.LSTM" if main else "f32 nn.LSTM (TF32 off)"

            (h, c), grids = launched(lstm_recurrence_cuda,
                                     lambda: lstm_recurrence_cuda(*args))
            require(grids == want, f"lstm_recurrence {kind} B={batch}: "
                    f"{grids} grids (all, f32 persistent), want {want}")
            hr, cr = lstm_recurrence_reference(*args)
            torch.cuda.synchronize()
            err = max(max_err(h, hr), max_err(c, cr))
            ms, plain_ms = timed_pair(
                torch, lambda: lstm_recurrence_reference(*args),
                lambda: lstm_recurrence_cuda(*args), iters=iters)
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library,
                     **bound(nbytes(x_proj, w_hh, lengths, h, c),
                             product_ops, kind)}
            report("lstm_recurrence", dtype, batch, err, tol, ms, plain_ms,
                   f", {yardstick} eval (with the input GEMM) "
                   f"{library:.4f} ms | bound {entry['bound_ms']:.4f} ms by "
                   f"{entry['bound_by']}")
            (by_batch if main else by_batch_f32)["lstm_recurrence"][
                batch] = entry

            # Kernel A: kernel 1's bits, plus the saved gates and carries.
            saved, grids = launched(lstm_recurrence_save_cuda,
                                    lambda: lstm_recurrence_save_cuda(*args))
            require(grids == want, f"lstm_recurrence_save {kind} "
                    f"B={batch}: {grids} grids, want {want}")
            plain_saved = lstm_recurrence_save_reference(*args)
            torch.cuda.synchronize()
            require(torch.equal(saved[0], h) and torch.equal(saved[1], c),
                    f"save mode changed kernel 1's bits ({dtype}, B={batch})")
            err = max(max_err(a, b) for a, b in zip(saved, plain_saved))
            del plain_saved
            ms, plain_ms = timed_pair(
                torch, lambda: lstm_recurrence_save_reference(*args),
                lambda: lstm_recurrence_save_cuda(*args), iters=iters)
            library = lstm_library_ms(torch, gen, device, lengths,
                                      train=True,
                                      dtype=None if main else torch.float32)
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library,
                     **bound(nbytes(x_proj, w_hh, lengths, *saved),
                             save_ops, kind)}
            report("lstm_recurrence_save", dtype, batch, err, tol, ms,
                   plain_ms, " | final (h, c) equal kernel 1's bits | "
                   f"{yardstick} train-mode forward (with the input GEMM) "
                   f"{library:.4f} ms | bound "
                   f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}")
            (by_batch if main else by_batch_f32)["lstm_recurrence_save"][
                batch] = entry
            if not main:
                # The co-attention's token states on their own store mode
                # and counter: kernel A's f32 bits of h, c and h_all, no
                # gates and no c_all written.
                states, grids = launched(
                    lstm_token_states_cuda,
                    lambda: lstm_token_states_cuda(*args))
                require(grids == want, f"lstm_token_states f32 B={batch}: "
                        f"{grids} grids, want {want}")
                torch.cuda.synchronize()
                require(all(torch.equal(states[k], saved[k])
                            for k in (0, 1, 4))
                        and (f32 != 1 or states[2] is None),
                        "lstm_token_states: kernel A's f32 bits")
                h_all, c_tok = lstm_token_states_reference(*args)
                err = max(max_err(states[4], h_all), max_err(states[1],
                                                             c_tok))
                del h_all, c_tok
                token_ms, token_plain_ms = timed_pair(
                    torch, lambda: lstm_token_states_reference(*args),
                    lambda: lstm_token_states_cuda(*args), iters=iters)
                library = lstm_library_ms(torch, gen, device, lengths,
                                          train=False, dtype=torch.float32)
                entry = {"max_abs_err": err, "ms": token_ms,
                         "plain_ms": token_plain_ms, "library_ms": library,
                         **bound(nbytes(x_proj, w_hh, lengths, states[1],
                                        states[4]), product_ops, "f32")}
                by_batch_f32["lstm_token_states"][batch] = entry
                report("lstm_token_states", dtype, batch, err, tol, token_ms,
                       token_plain_ms,
                       f" | kernel A's f32 bits | {yardstick} eval (with "
                       f"the input GEMM) {library:.4f} ms | bound "
                       f"{entry['bound_ms']:.4f} ms by {entry['bound_by']}")
                del states
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
    # The batch-512 entries lead the result line (bf16 for kernels 1 and
    # A, whose f32 entries ride along under "f32"); the serving buckets
    # under "by_batch".
    def rest(entries):
        return {str(b): entry for b, entry in entries.items() if b != BATCH}

    for name, entries in by_batch.items():
        summary[name] = {**entries[BATCH], "by_batch": rest(entries),
                         "f32": {str(b): entry for b, entry
                                 in by_batch_f32[name].items()}}
    tokens = by_batch_f32["lstm_token_states"]
    summary["lstm_token_states"] = {**tokens[BATCH],
                                    "by_batch": rest(tokens)}


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
    """Kernels 4 and 5 at S=196, H=4, D=64, batches 1, 8 and 512, and at
    H=2, D=128 (the head walked in two 64-wide slices) at batch 512, whose
    numbers go under ``head128`` in the kernels line."""
    import torch.nn.functional as F

    from dl_vqa_tpu_torch.ops.vit_attention import (
        vit_attention_backward_cuda, vit_attention_backward_reference,
        vit_attention_cuda, vit_attention_reference)

    for heads, head, batches in ((VIT_HEADS, VIT_HEAD, (1, 8, BATCH)),
                                 (2, 128, (BATCH,))):
        vit_kernel_rows(torch, gen, device, summary, heads, head, batches,
                        F, vit_attention_cuda, vit_attention_reference,
                        vit_attention_backward_cuda,
                        vit_attention_backward_reference)


def vit_kernel_rows(torch, gen, device, summary, heads, head, batches, F,
                    vit_attention_cuda, vit_attention_reference,
                    vit_attention_backward_cuda,
                    vit_attention_backward_reference) -> None:
    """Kernels 4 and 5 at ``heads`` heads of ``head``, S = 196: each batch
    held to the plain versions and timed beside them and SDPA."""
    dim = heads * head
    label = "" if head == VIT_HEAD else f" {heads} heads of {head}"

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
        q, k, v = (t.reshape(batch, VIT_TOKENS, heads, head).transpose(1, 2)
                   for t in x.chunk(3, dim=-1))
        return F.scaled_dot_product_attention(q, k, v).transpose(
            1, 2).reshape(batch, VIT_TOKENS, dim)

    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        kind = "bf16" if main else "f32"
        for batch in batches:
            iters = 10 if main or batch < BATCH else 3
            qkv = torch.randn(batch, VIT_TOKENS, 3 * dim, generator=gen,
                              device=device).to(dtype)
            g = torch.randn(batch, VIT_TOKENS, dim, generator=gen,
                            device=device).to(dtype)
            pairs = batch * heads
            product = 2.0 * pairs * VIT_TOKENS * VIT_TOKENS * head

            out = vit_attention_cuda(qkv, heads)
            torch.cuda.synchronize()
            err, tol, note = check(
                "vit_attention", dtype, batch, out,
                vit_attention_reference(qkv, heads),
                TOL["vit_attention_bf16_steps"])
            ms, plain_ms = timed_pair(
                torch, lambda: vit_attention_reference(qkv, heads),
                lambda: vit_attention_cuda(qkv, heads), iters=iters)
            library_ms = timed(torch, lambda: library(qkv), iters=iters)
            least = bound(nbytes(qkv, out), 2 * product, kind)
            log(f"kernel vit_attention{label} {kind} qkv {list(qkv.shape)}: "
                f"max_abs_err {err:.3e} (tol {tol:.3g}){note} | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention with split and merge "
                f"{library_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
                f"{least['bound_by']}")
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, **least}
            if batch == BATCH and head != VIT_HEAD:
                summary["vit_attention"].setdefault(
                    f"head{head}", {})[kind] = row
            elif main and batch == BATCH:
                summary["vit_attention"] = row

            dqkv = vit_attention_backward_cuda(qkv, g, heads)
            again = vit_attention_backward_cuda(qkv, g, heads)
            torch.cuda.synchronize()
            require(torch.equal(dqkv, again),
                    f"vit_attention_backward {kind} B={batch}: two runs "
                    "gave other digits")
            err, tol, note = check(
                "vit_attention_backward", dtype, batch, dqkv,
                vit_attention_backward_reference(qkv, g, heads),
                TOL["vit_attention_backward_bf16_steps"])
            del again
            ms, plain_ms = timed_pair(
                torch,
                lambda: vit_attention_backward_reference(qkv, g, heads),
                lambda: vit_attention_backward_cuda(qkv, g, heads),
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
            log(f"kernel vit_attention_backward{label} {kind} qkv "
                f"{list(qkv.shape)}: max_abs_err {err:.3e} (tol {tol:.3g})"
                f"{note}, the same digits on two runs | kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, the backward of "
                f"F.scaled_dot_product_attention with split and merge "
                f"{library_ms:.4f} ms, bound {least['bound_ms']:.4f} ms by "
                f"{least['bound_by']}")
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, **least}
            if batch == BATCH and head != VIT_HEAD:
                summary["vit_attention_backward"].setdefault(
                    f"head{head}", {})[kind] = row
            elif main and batch == BATCH:
                summary["vit_attention_backward"] = row
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


def same_bits(torch, got, want) -> float:
    """0 where ``got`` and ``want`` are equal with NaN at the same places,
    else the largest difference (inf for a NaN out of place)."""
    got, want = got.float(), want.float()
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    keep = ~torch.isnan(want)
    return max_err(got[keep], want[keep]) if keep.any() else 0.0


def quant_kernels(torch, gen, device, summary) -> None:
    """The quantized serving modes' kernels at the model's shapes: kernel
    2's e4m3 mode at the three conv outputs (the f8 store; values above 464
    among them, and one window a value around that edge), its int8 mode at
    conv0's output (the int8 stem's first block; the others too, for the
    bits), and kernel D at conv1 and conv2 (its wgmma kernel, at B = 512
    and at the serving buckets), each against its plain version with
    tolerance 0; kernel D beside the bf16 block it replaces (``conv_nhwc``
    then kernel 2) at the same shapes, in turns; and a stride-2 shape on
    kernel D's mma.sync kernel, equal in bits."""
    from dl_vqa_tpu_torch.ops.conv_fused import (
        conv_nhwc, relu_maxpool_cuda, relu_maxpool_e4m3_cuda,
        relu_maxpool_e4m3_reference)
    from dl_vqa_tpu_torch.ops.conv_int8 import (
        conv_relu_pool_w8a8_cuda, conv_relu_pool_w8a8_reference,
        pack_int8_weight_wgmma, quantize_relu_pool_cuda,
        quantize_relu_pool_reference, quantize_weights_per_channel,
        w8a8_plan)

    # The e4m3 edge: one window a value, 464 -> 448, above it NaN.
    edge = torch.tensor([464.0, 464.01, 465.0, 448.0, 1e5, 300.0, -3.0,
                         2.0 ** -10], device=device)
    y = edge[None, None, :, None].repeat_interleave(2, 2).repeat(1, 2, 1, 1)
    b = torch.zeros(1, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        got = relu_maxpool_e4m3_cuda(y.to(dtype).contiguous(), b)
        want = relu_maxpool_e4m3_reference(y.to(dtype), b)
        err = same_bits(torch, got, want)
        log(f"kernel relu_maxpool_e4m3 {str(dtype)[6:]} edge cases "
            f"{edge.tolist()} -> {got.flatten().float().tolist()}: error "
            f"{err:g} (tol {TOL['relu_maxpool_e4m3']:g})")
        # In bf16 the input itself rounds 464.01 and 465 to 464 first.
        edge_ok = (dtype != torch.float32 or (
            bool(torch.isnan(got.flatten()[1:3]).all())
            and float(got.flatten()[0]) == 448.0))
        require(err <= TOL["relu_maxpool_e4m3"] and edge_ok,
                f"relu_maxpool_e4m3 at the overflow edge: {got.flatten()}")

    e4m3 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "library_ms": None, "bytes": 0}
    int8 = dict(e4m3)
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        for i, shape in enumerate(CONV_OUTPUTS):
            y = (torch.randn(*shape, generator=gen, device=device)
                 * 150).to(dtype)
            b = torch.randn(shape[-1], generator=gen, device=device)
            out = relu_maxpool_e4m3_cuda(y, b)
            err = same_bits(torch, out, relu_maxpool_e4m3_reference(y, b))
            nans = float(torch.isnan(out.float()).float().mean())
            ms, plain_ms = timed_pair(
                torch, lambda: relu_maxpool_e4m3_reference(y, b),
                lambda: relu_maxpool_e4m3_cuda(y, b), iters=3)
            log(f"kernel relu_maxpool_e4m3 {str(dtype)[6:]} {list(shape)}: "
                f"error {err:g} (tol {TOL['relu_maxpool_e4m3']:g}), "
                f"{nans:.2e} of the outputs NaN | kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
            require(err <= TOL["relu_maxpool_e4m3"] and nans > 0,
                    f"relu_maxpool_e4m3 {shape}: {err}, NaN share {nans}")
            if main:
                e4m3["ms"] += ms
                e4m3["plain_ms"] += plain_ms
                e4m3["bytes"] += nbytes(y, b, out)
            del out
            # Values of unit size against s_out = 3: a few percent of the
            # windows saturate at 127, a few are all below zero.
            s_out = 3.0
            y = (y / 150).to(dtype)
            q = quantize_relu_pool_cuda(y, b, s_out)
            err = max_err(q, quantize_relu_pool_reference(y, b, s_out))
            shares = [float((q == c).float().mean()) for c in (0, 127)]
            log(f"kernel relu_maxpool_int8 {str(dtype)[6:]} {list(shape)}: "
                f"max code difference {err:g} (tol "
                f"{TOL['relu_maxpool_int8']:g}), codes 0 / 127: "
                f"{shares[0]:.3f} / {shares[1]:.3f}")
            require(err <= TOL["relu_maxpool_int8"]
                    and shares[0] < 0.9 and shares[1] < 0.5,
                    f"relu_maxpool_int8 {shape}: {err}, {shares}")
            if main and i == 0:  # the int8 stem's block
                ms, plain_ms = timed_pair(
                    torch, lambda: quantize_relu_pool_reference(y, b, s_out),
                    lambda: quantize_relu_pool_cuda(y, b, s_out), iters=3)
                log(f"kernel relu_maxpool_int8 bf16 {list(shape)}: kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
                int8.update(ms=ms, plain_ms=plain_ms, bytes=nbytes(y, b, q))
            del y, q
    for entry in (e4m3, int8):
        moved = entry.pop("bytes")
        entry.update(bound(moved, 0.0, "f32"))
    summary["relu_maxpool_e4m3"] = e4m3
    summary["relu_maxpool_int8"] = int8

    # Kernel D at conv1 and conv2 of the reference model, batch 512: the
    # wgmma kernel (w8a8_plan), each call counted by launches_wgmma. The
    # part's seconds on the host's clock (phase_s) go into its entry.
    d_start = time.perf_counter()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    block = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "library_ms": None, "bf16_block_ms": 0.0, "per_block_ms": [],
             "kernel": "wgmma", "serving_ms": {}, "bf16_serving_ms": {}}
    moved, ops = 0, 0.0
    d = conv_relu_pool_w8a8_cuda
    for size, cin, cout in FUSED_BLOCKS:
        plan = w8a8_plan(size, size, cin, cout, 3, 1, sms)
        require(plan.kernel == "wgmma", f"kernel D's plan at {size} px: {plan}")
        x = torch.randint(0, 128, (BATCH, size, size, cin), generator=gen,
                          device=device, dtype=torch.int8)
        w = torch.randn(cout, cin, 3, 3, generator=gen, device=device) * 0.05
        b = torch.randn(cout, generator=gen, device=device) * 0.1
        s_in = 3.0
        # s_out: the amax of the block's post-ReLU output on two images,
        # so that the codes spread over [0, 127].
        w_q, w_scale = quantize_weights_per_channel(w)
        probe = conv_nhwc(x[:2].double(), w_q.double()).float() * (
            w_scale * float(np.float32(s_in / 127.0))) + b
        s_out = float(probe.clamp(min=0).amax())
        before = (d.launches, d.launches_wgmma)
        out = d(x, s_in, w, b, 1, s_out)
        require((d.launches, d.launches_wgmma) == (before[0] + 1,
                                                   before[1] + 1),
                f"kernel D at {size} px ran the wgmma kernel once")
        want = conv_relu_pool_w8a8_reference(x, s_in, w, b, 1, s_out)
        torch.cuda.synchronize()
        err = max_err(out, want)
        positive = float((out > 0).float().mean())
        del want
        xb = x.to(torch.bfloat16)
        plain_ms = timed(torch, lambda: conv_relu_pool_w8a8_reference(
            x, s_in, w, b, 1, s_out), iters=2, warmup=1)
        ms, bf16_ms = timed_turns(
            torch, [lambda: d(x, s_in, w, b, 1, s_out),
                    lambda: relu_maxpool_cuda(conv_nhwc(xb, w), b)],
            iters=20)
        hp = (size - 2) // 2
        block_ops = 2.0 * BATCH * (2 * hp) ** 2 * cout * 9 * cin
        log(f"kernel conv_relu_pool_int8 ({plan.kernel}, {plan.warp_rows} x "
            f"{4 * plan.warp_cols} windows a tile, {plan.channels} channels "
            f"a block, {plan.shared} B shared) x {list(x.shape)} -> "
            f"{list(out.shape)}: max code difference {err:g} (tol "
            f"{TOL['conv_relu_pool_int8']:g}), {positive:.3f} of the codes "
            f"above 0 | kernel {ms:.4f} ms = {block_ops / ms / 1e9:.1f} TOP/s,"
            f" plain (float64) {plain_ms:.4f} ms, the bf16 block it replaces "
            f"(conv_nhwc + kernel 2) {bf16_ms:.4f} ms")
        require(err <= TOL["conv_relu_pool_int8"] and 0.05 < positive < 0.95,
                f"conv_relu_pool_int8 {list(x.shape)}: {err}, {positive}")
        # The serving buckets: the same codes, and the kernel's time in
        # turns with the bf16 block's.
        for sb in LATENCY_BATCHES:
            xs, xsb = x[:sb], xb[:sb]
            got = d(xs, s_in, w, b, 1, s_out)
            small_err = max_err(got, conv_relu_pool_w8a8_reference(
                xs, s_in, w, b, 1, s_out))
            require(small_err <= TOL["conv_relu_pool_int8"],
                    f"conv_relu_pool_int8 at B = {sb}: {small_err}")
            k_ms, bf_ms = timed_turns(
                torch, [lambda: d(xs, s_in, w, b, 1, s_out),
                        lambda: relu_maxpool_cuda(conv_nhwc(xsb, w), b)],
                iters=20)
            log(f"kernel conv_relu_pool_int8 at B = {sb}, {size} px: codes "
                f"equal ({small_err:g}) | kernel {k_ms:.4f} ms, bf16 block "
                f"{bf_ms:.4f} ms")
            key = str(sb)
            block["serving_ms"][key] = block["serving_ms"].get(key, 0.0) + k_ms
            block["bf16_serving_ms"][key] = (
                block["bf16_serving_ms"].get(key, 0.0) + bf_ms)
        block["max_abs_err"] = max(block["max_abs_err"], err)
        block["ms"] += ms
        block["plain_ms"] += plain_ms
        block["bf16_block_ms"] += bf16_ms
        block["per_block_ms"].append(ms)
        moved += nbytes(x, pack_int8_weight_wgmma(w_q, plan), w_scale, b, out)
        ops += block_ops
        del x, xb, out, probe
    block["top_s"] = ops / block["ms"] / 1e9

    # A shape the wgmma kernel does not take (stride 2) keeps the mma.sync
    # kernel, equal in bits.
    x = torch.randint(0, 128, (8, 55, 55, 64), generator=gen, device=device,
                      dtype=torch.int8)
    w = torch.randn(128, 64, 3, 3, generator=gen, device=device) * 0.05
    b = torch.randn(128, generator=gen, device=device) * 0.1
    require(w8a8_plan(55, 55, 64, 128, 3, 2, sms).kernel == "mma_sync",
            "stride 2 takes the mma.sync kernel")
    before = (d.launches, d.launches_wgmma)
    err = max_err(d(x, 3.0, w, b, 2, 4.0),
                  conv_relu_pool_w8a8_reference(x, 3.0, w, b, 2, 4.0))
    require((d.launches, d.launches_wgmma) == (before[0] + 1, before[1]),
            "stride 2 ran the mma.sync kernel once")
    log(f"kernel conv_relu_pool_int8 (mma.sync) stride 2 x {list(x.shape)}: "
        f"max code difference {err:g} (tol {TOL['conv_relu_pool_int8']:g})")
    require(err <= TOL["conv_relu_pool_int8"],
            f"conv_relu_pool_int8 stride 2: {err}")
    block["stride2_max_abs_err"] = err
    block["phase_s"] = time.perf_counter() - d_start
    log(f"kernel conv_relu_pool_int8: its checks and timings took "
        f"{block['phase_s']:.1f} s")
    summary["conv_relu_pool_int8"] = {**block, **bound(moved, ops, "int8")}


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
    quant_kernels(torch, gen, device, summary)

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
        relu_maxpool_backward_cuda, relu_maxpool_cuda, relu_maxpool_e4m3_cuda)
    from dl_vqa_tpu_torch.ops.conv_int8 import (
        conv_relu_pool_w8a8_cuda, quantize_relu_pool_cuda)
    from dl_vqa_tpu_torch.ops.layout_cases import layout_cases_cuda
    from dl_vqa_tpu_torch.ops.lstm_cuda import (
        lstm_backward_step_cuda, lstm_recurrence_cuda,
        lstm_recurrence_save_cuda, lstm_token_states_cuda)
    from dl_vqa_tpu_torch.ops.vit_attention import (
        vit_attention_backward_cuda, vit_attention_cuda)
    from dl_vqa_tpu_torch.ops.vit_mlp_fused import fused_ln_mlp_cuda

    return {"lstm_recurrence": lstm_recurrence_cuda,
            "lstm_recurrence_save": lstm_recurrence_save_cuda,
            "lstm_token_states": lstm_token_states_cuda,
            "lstm_backward_step": lstm_backward_step_cuda,
            "relu_maxpool": relu_maxpool_cuda,
            "relu_maxpool_backward": relu_maxpool_backward_cuda,
            "attention_pool": attention_pool_cuda,
            "vit_attention": vit_attention_cuda,
            "vit_attention_backward": vit_attention_backward_cuda,
            "conv_relu_pool_fused": conv_relu_pool_fused_cuda,
            "conv_relu_pool_stem": conv_relu_pool_stem_cuda,
            "vit_mlp_fused": fused_ln_mlp_cuda,
            "layout_cases": layout_cases_cuda,
            "relu_maxpool_e4m3": relu_maxpool_e4m3_cuda,
            "relu_maxpool_int8": quantize_relu_pool_cuda,
            "conv_relu_pool_int8": conv_relu_pool_w8a8_cuda}


# Kernels that count the grids of their fast path beside all their grids:
# kernel C's and kernel B's vector kernels, kernel 7's tensor-core kernel,
# kernel D's wgmma kernel and the token states' f32 persistent kernel,
# which every call of a model path takes (the model's shapes, in bf16; D's
# in int8; the token states in f32 on a card of 128 SMs or more).
FAST_PATHS = {"relu_maxpool_backward": "launches_vector",
              "lstm_backward_step": "launches_vector",
              "conv_relu_pool_stem": "launches_mma",
              "conv_relu_pool_int8": "launches_wgmma",
              "lstm_token_states": "launches_f32_persistent"}


def reset_launches(wrappers) -> None:
    """Every launch count to 0, the fast paths' too."""
    for name, fn in wrappers.items():
        fn.launches = 0
        if name in FAST_PATHS:
            setattr(fn, FAST_PATHS[name], 0)


def read_launches(wrappers, what: str) -> dict:
    """The grids each kernel launched since :func:`reset_launches`; fails
    where kernel C, B, 7, D or the token states launched a grid off its
    fast path."""
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
                fused: bool = False, profile: bool = False,
                numbers: dict = None) -> dict:
    """A Predictor over ``cfg`` answers the requests; ``expected`` holds
    the grids each kernel must have launched for them. ``fused`` serves
    with ``fused_ops=True``: the logits are also held to the unfused kernel
    path, and the forward is timed with the flip on and off. ``numbers``,
    where given, takes the batch-512 forward's ms on both paths."""
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
        with RecordedRoutes() as kernel_routes:
            kernel = predictor.forward_logits(images, encoded, lengths)
        with RecordedRoutes() as plain_routes:
            plain = predictor.forward_logits(images, encoded, lengths,
                                             plain_ops=True)
        require(kernel.shape == (len(QUESTIONS), cfg.max_answers),
                "logits shape")
        require(bool(np.isfinite(kernel).all()), "finite logits")
        flips, flipped = route_flips(kernel_routes, plain_routes)
        held = np.ones(len(QUESTIONS), dtype=bool)
        if flipped is not None:
            # A MoE model: a request with a flipped route is held to
            # logits_moe_flipped, the others to the dense tolerance.
            flipped = flipped[:len(QUESTIONS)]
            held = ~flipped
            moe_err = float(np.abs(kernel - plain)[flipped].max(initial=0.0))
            log(f"slice {label} {str(dtype)[6:]}: {flips:.4%} of the routes "
                f"differ between the kernel and plain paths, "
                f"{int(flipped.sum())} of {len(flipped)} requests with a "
                f"flipped route, their logits max |kernel - plain| "
                f"{moe_err:.3e} (tol {TOL['logits_moe_flipped']:g})")
            require(moe_err <= TOL["logits_moe_flipped"],
                    f"logits of requests with a flipped route {dtype}: "
                    f"{moe_err}")
            if numbers is not None:
                numbers.setdefault("route_flips_served", {})[
                    str(dtype)[6:]] = flips
        err = float(np.abs(kernel - plain)[held].max(initial=0.0))
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
            f"{err:.3e} (tol {tol:g}"
            + ("" if held.all() else
               f"; the {int(held.sum())} requests without a flipped route")
            + f"), max |logit| {np.abs(plain).max():.3e}")
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
    if numbers is not None:
        numbers.update(forward_ms=ms, forward_plain_ms=plain_ms,
                       forward_qa_s=BATCH / ms * 1e3,
                       forward_peak_gib=peak)
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
    ("kernel D, W8A8 conv block", ("conv_relu_pool_int8_wgmma_kernel",
                                   "conv_relu_pool_int8_kernel")),
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


def shifts_a_softmax(name: str) -> bool:
    """The biases that only shift a softmax over the grid: the glimpse
    scores' (single and co attention's ``x_conv``, stacked attention's
    ``layers.{g}.score``). Their true gradient is zero."""
    return name == "attention.x_conv.bias" or (
        name.startswith("attention.layers.") and name.endswith(".score.bias"))


def hold_to_plain_path(torch, seed: int, cfg, name: str, gen,
                       new_state, numbers: dict = None) -> None:
    """At batch 8 without dropout, one train step each on the kernel path
    and on the plain path from the same weights (``new_state``), f32 and
    bf16, every gradient held to the plain path's; then the eval step both
    ways. A MoE model's share of flipped routes goes to ``numbers``."""
    from dl_vqa_tpu_torch.train import make_eval_step, make_train_step

    vit = cfg.image.encoder == "vit"
    lstm_co = cfg.text.encoder == "lstm" and cfg.attention.variant == "co"
    cfg0 = without_dropout(cfg)
    small = make_batch(torch, cfg0, 8, seed + 1)
    reference = None
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        grads, routes = {}, {}
        for plain in (False, True):
            state_8 = new_state(cfg0)
            with RecordedRoutes() as routes[plain]:
                make_train_step(cfg0, compute_dtype=dtype, plain_ops=plain)(
                    state_8, small, gen)
            grads[plain] = {n: p.grad for n, p in
                            state_8.model.named_parameters()
                            if p.grad is not None}
        flips, _ = route_flips(routes[False], routes[True])
        if cfg.image.moe_experts:
            log(f"train {name} {dname} B=8: {flips:.4%} of the routes differ "
                "between the kernel and plain paths' train steps")
            if numbers is not None:
                numbers.setdefault("route_flips_train", {})[dname] = flips
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
            require(float(want.abs().max()) > 0 or shifts_a_softmax(n),
                    f"gradient of {n} is zero")
            # A glimpse's score bias has gradient zero (a softmax ignores a
            # shift); what it holds is rounding noise.
            if shifts_a_softmax(n):
                continue
            tol = TOL["grads_" + dname]
            if dname == "bf16" and lstm_co:
                tol = TOL["grads_bf16_lstm_co"]
            if dname == "bf16" and n.startswith("attention."):
                tol = TOL["grads_bf16_attention"]
            elif dname == "bf16" and vit and n.startswith("image."):
                tol = TOL["grads_bf16_vit_image"]
            if flips > 0:
                tol = max(tol, TOL["grads_moe_flipped"])
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


def train_phase(torch, seed: int, profile: bool, cfg, name: str,
                expected: dict, accumulate: bool, steps: int = TRAIN_STEPS,
                numbers: dict = None) -> dict:
    """A trainer over ``cfg``; ``expected`` holds the grids each kernel
    must have launched in ``steps`` train steps and one eval step.
    ``numbers``, where given, takes the train step's ms on both paths."""
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import (
        create_train_state, lr_schedule, make_eval_step, make_train_step)

    wrappers = kernel_wrappers()

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
    balance = []
    for _ in range(steps):
        state, metrics = train_step(state, batch, gen)
        losses.append(metrics["loss"])
        scores.append(metrics["score"])
        if "moe_aux" in metrics:
            balance.append(metrics["moe_aux"])
    eval_loss, eval_score = eval_step(state.model, batch)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, f"the {name} trainer's path")
    losses = [float(x) for x in losses]
    log(f"train {name} B={BATCH} bf16 dropout 0.3: losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + " | scores " + " ".join(f"{float(x):.1f}" for x in scores)
        + f" | eval loss {float(eval_loss):.4f} score "
        f"{float(eval_score):.1f}")
    if balance:
        balance = [float(x) for x in balance]
        log(f"train {name}: moe_aux (the blocks' mean balance loss, 1.0 at "
            "uniform routing) " + " ".join(f"{x:.4f}" for x in balance))
        require(all(np.isfinite(balance)), "finite moe_aux")
        if numbers is not None:
            numbers["moe_aux"] = balance
    log(f"train {name}: kernel launches {json.dumps(launches)}")
    require(all(np.isfinite(losses)) and bool(torch.isfinite(eval_loss)),
            "finite losses")
    require(losses[-1] < losses[0], "the loss falls on a repeated batch")
    require(all(bool(torch.isfinite(p).all())
                for p in state.model.parameters()), "finite parameters")
    require(state.step == steps, "one update per step")
    used = state.optimizer.param_groups[0]["lr"]
    require(abs(used - INITIAL_LR * 0.5 ** ((steps - 1) / 50000)) < 1e-12
            and abs(lr_schedule(INITIAL_LR)(state.step)
                    - INITIAL_LR * 0.5 ** (steps / 50000)) < 1e-12,
            "the LR follows the halving law")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on the {name} trainer's path: {launches}, "
            f"expected {expected}")

    # Kernel path against plain path at batch 8 without dropout.
    hold_to_plain_path(torch, seed, cfg, name, gen, new_state, numbers)

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
    if numbers is not None:
        numbers.update(train_step_ms=ms, train_step_plain_ms=plain_ms,
                       train_samples_s=BATCH / ms * 1e3,
                       train_peak_gib=peaks["kernel"], losses=losses)

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


CALIBRATION_IMAGES = 64  # random images the int8 serving paths calibrate on
LATENCY_BATCHES = (1, 8, 64)


def serving_inputs(torch, cfg, batch: int, seed: int):
    """uint8 images, question ids and lengths on the card, from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs = torch.randint(0, 256, (batch, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device="cuda", dtype=torch.uint8)
    lens = torch.randint(1, SEQ_LEN + 1, (batch,), generator=gen,
                         device="cuda", dtype=torch.int32)
    qs = torch.randint(1, cfg.num_tokens, (batch, SEQ_LEN), generator=gen,
                       device="cuda", dtype=torch.int32)
    return imgs, qs * (torch.arange(SEQ_LEN, device="cuda")[None]
                       < lens[:, None]), lens


def quant_serving_phase(torch, seed: int, cfg, name: str, store: str,
                        expected: dict, profile: bool = False) -> tuple:
    """A Predictor over ``cfg`` in the serving mode ``store`` (``f8e4m3``,
    or ``int8`` calibrated first by ``Predictor.calibrate_int8`` on random
    images) answers the requests; ``expected`` holds the grids each kernel
    must have launched for them. The logits are held to the plain path's
    in bf16 and f32, and must differ from the ``compute`` mode's; then the
    batch-512 forward and the forward at the latency buckets are timed in
    turns with the ``compute`` mode of the same weights. Returns
    ``(launches, numbers)``."""
    import dataclasses

    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.predict import Predictor

    wrappers = kernel_wrappers()
    label = f"{name} {store}"
    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    predictor = Predictor(
        dataclasses.replace(cfg, image=dataclasses.replace(
            cfg.image, store_dtype=store)), model,
        make_vocab(cfg.num_tokens, cfg.max_answers), device="cuda",
        max_question_length=SEQ_LEN, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    numbers = {}
    if store == "int8":
        require(predictor.needs_int8_calibration, "int8 asks for scales")
        sample = rng.integers(0, 256, (CALIBRATION_IMAGES, cfg.image_size,
                                       cfg.image_size, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        predictor.calibrate_int8(sample)
        numbers["calibration_s"] = time.perf_counter() - t0
        scales = predictor.model_cfg.image.quant_scales
        log(f"slice {label}: calibrated on {CALIBRATION_IMAGES} images in "
            f"{numbers['calibration_s']:.2f} s, scales "
            + ", ".join(f"{v:.4f}" for v in scales))
        require(not predictor.needs_int8_calibration, "calibrated")
    quant_cfg = predictor.model_cfg
    images = rng.integers(0, 256, (len(QUESTIONS), cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    reset_launches(wrappers)
    answers = predictor.predict(images, QUESTIONS, top_k=3)
    launches = read_launches(wrappers, f"the {label} serving path")
    log(f"slice {label}: {len(answers)} requests answered, top-1 "
        + ", ".join(top[0][0] for top in answers)
        + f" | kernel launches {json.dumps(launches)}")
    require(len(answers) == len(QUESTIONS)
            and all(len(top) == 3 for top in answers), "top-3 per request")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on the {label} serving path: {launches}, "
            f"expected {expected}")

    encoded, lengths = predictor.encode_questions(QUESTIONS)
    vit_int8 = cfg.image.encoder == "vit"
    for dtype, tol in ((torch.bfloat16, TOL["logits_bf16"]),
                       (torch.float32, TOL["logits_f32_int8_vit"] if vit_int8
                        else TOL["logits_f32"])):
        predictor.compute_dtype = dtype
        kernel = predictor.forward_logits(images, encoded, lengths)
        plain = predictor.forward_logits(images, encoded, lengths,
                                         plain_ops=True)
        model.configure(cfg)
        compute = predictor.forward_logits(images, encoded, lengths)
        model.configure(quant_cfg)
        err = float(np.abs(kernel - plain).max())
        moved = float(np.abs(kernel - compute).max())
        log(f"slice {label} logits {str(dtype)[6:]}: finite "
            f"{bool(np.isfinite(kernel).all())}, max |kernel - plain| "
            f"{err:.3e} (tol {tol:g}), max |{store} - compute| {moved:.3e}")
        require(kernel.shape == (len(QUESTIONS), cfg.max_answers)
                and bool(np.isfinite(kernel).all()), "finite logits")
        require(err <= tol, f"{label} kernel vs plain logits {dtype}: {err}")
        require(moved > 0, f"{label}: the mode changes the logits")
        numbers[f"logits_err_{str(dtype)[6:]}"] = err
    predictor.compute_dtype = torch.bfloat16

    imgs, qs, lens = serving_inputs(torch, cfg, BATCH, seed)

    def forward(mode_cfg, b):
        def run():
            model.configure(mode_cfg)
            with torch.inference_mode():
                return model(imgs[:b], qs[:b], lens[:b],
                             compute_dtype=torch.bfloat16)
        return run

    out = forward(quant_cfg, BATCH)()
    require(bool(torch.isfinite(out).all()), "finite batch-512 logits")
    compute_ms, ms = timed_turns(torch, [forward(cfg, BATCH),
                                         forward(quant_cfg, BATCH)], iters=3)
    numbers.update(ms=ms, qa_per_s=BATCH / ms * 1e3, compute_ms=compute_ms,
                   compute_qa_per_s=BATCH / compute_ms * 1e3, latency_ms={},
                   compute_latency_ms={})
    for b in LATENCY_BATCHES:
        c_ms, q_ms = timed_turns(torch, [forward(cfg, b),
                                         forward(quant_cfg, b)], iters=10)
        numbers["latency_ms"][b] = q_ms
        numbers["compute_latency_ms"][b] = c_ms
    if profile:
        profile_steps(torch, forward(quant_cfg, BATCH), ms,
                      f"{label} forward")
    model.configure(quant_cfg)
    log(f"forward {label} B={BATCH} bf16: {ms:.3f} ms = "
        f"{numbers['qa_per_s']:.1f} QA/s | compute mode {compute_ms:.3f} ms "
        f"= {numbers['compute_qa_per_s']:.1f} QA/s | latency ms at B = "
        + ", ".join(f"{b}: {numbers['latency_ms'][b]:.3f} (compute "
                    f"{numbers['compute_latency_ms'][b]:.3f})"
                    for b in LATENCY_BATCHES))
    return launches, numbers


def f8_train_phase(torch, seed: int, cfg, expected: dict) -> tuple:
    """One train step of ``cfg`` with the f8 store at batch 512 (bf16,
    dropout 0.3; kernel 2's e4m3 mode forward, kernel C backward: the
    straight-through estimator), its gradients at batch 8 held to the plain
    path's, and the step timed in turns with the ``compute`` step. Returns
    ``(launches, numbers)``."""
    import dataclasses

    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import create_train_state, make_train_step

    wrappers = kernel_wrappers()
    f8 = dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, store_dtype="f8e4m3"))

    def new_state(model_cfg):
        model = VqaNet(model_cfg,
                       generator=torch.Generator().manual_seed(seed))
        return create_train_state(model, INITIAL_LR)

    batch = make_batch(torch, f8, BATCH, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state, step = new_state(f8), make_train_step(f8)
    reset_launches(wrappers)
    state, metrics = step(state, batch, gen)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, "the cnn f8 train step")
    log(f"train cnn f8e4m3 B={BATCH} bf16 dropout 0.3: loss "
        f"{float(metrics['loss']):.4f} | kernel launches "
        f"{json.dumps(launches)}")
    require(bool(torch.isfinite(metrics["loss"])), "finite f8 loss")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches of the cnn f8 train step: {launches}, expected "
            f"{expected}")
    hold_to_plain_path(torch, seed, f8, "cnn f8e4m3", gen, new_state)
    compute_state, compute_step = new_state(cfg), make_train_step(cfg)
    compute_ms, ms = timed_turns(
        torch, [lambda: compute_step(compute_state, batch, gen),
                lambda: step(state, batch, gen)], iters=3, warmup=1)
    log(f"train step cnn f8e4m3 B={BATCH} bf16: {ms:.3f} ms = "
        f"{BATCH / ms * 1e3:.1f} samples/s | compute mode {compute_ms:.3f} "
        f"ms = {BATCH / compute_ms * 1e3:.1f} samples/s")
    return launches, {"ms": ms, "samples_per_s": BATCH / ms * 1e3,
                      "compute_ms": compute_ms,
                      "compute_samples_per_s": BATCH / compute_ms * 1e3}


def e2e_quant_eval_phase(torch, seed: int, prof: dict,
                         best: float) -> tuple:
    """``evaluate_vqa`` on the cnn_e2e run's best checkpoint in the f8 and
    the int8 mode (int8 calibrated on 256 images of the corpus's train
    store, as the entry point does for a checkpoint without scales): each
    score within ``TOL["quant_eval_pp"]`` of the loop's best. Returns
    ``(launches, scores)``."""
    import contextlib
    import os

    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2

    wrappers = kernel_wrappers()
    root = os.path.abspath(E2E_DIR)
    best_ckpt = os.path.join(exp_dir_of(root, "e2e_straight"), "model.ckpt")
    reset_launches(wrappers)
    scores, seconds = {}, {}
    for mode in ("f8e4m3", "int8"):
        t0 = time.perf_counter()
        with open(os.path.join(root, f"evaluate_{mode}_stdout.txt"),
                  "w") as out, contextlib.redirect_stdout(out):
            scores[mode] = evaluate_hw2(e2e_overrides(
                prof, root, f"e2e_eval_{mode}", seed, [
                    f"main.small.paths.pretrained_model_path={best_ckpt}",
                    "train.image.stride=1", "train.attention.do_option=+",
                    f"train.image.store_dtype={mode}"]))
        seconds[mode] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches(wrappers, "the cnn_e2e quantized evaluations")
    batches = -(-E2E_VAL // BATCH)
    grids = recurrence_grids(torch)
    expected = {"lstm_recurrence": 2 * batches * (1 if grids == 1
                                                  else SEQ_LEN),
                "attention_pool": 2 * batches,
                "relu_maxpool_e4m3": 3 * batches,
                "relu_maxpool_int8": batches,
                "conv_relu_pool_int8": 2 * batches}
    log(f"cnn_e2e evaluate_vqa on the best checkpoint: compute {best:.4f} "
        f"(the loop's), f8e4m3 {scores['f8e4m3']}, int8 {scores['int8']} "
        f"(tol {TOL['quant_eval_pp']:g} pp) in {json.dumps(seconds)} s | "
        f"kernel launches {json.dumps(launches)}")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches of the quantized evaluations: {launches}, "
            f"expected {expected}")
    for mode, score in scores.items():
        require(abs(score - best) <= TOL["quant_eval_pp"],
                f"evaluate_vqa {mode} {score} vs compute {best}")
    return launches, {"scores": scores, "seconds": seconds,
                      "compute_score": best}


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


# The cnn_e2e path: a corpus of the numpy generator at 224 px, trained and
# evaluated through the port's entry points at full width.
E2E_DIR = "_smoke_e2e"  # under the checkout; .gitignore lists it
E2E_TRAIN, E2E_VAL, E2E_IMAGES, E2E_VAL_IMAGES = 4096, 1024, 512, 128
E2E_IMAGE_SIZE = 224
E2E_EPOCHS, E2E_EVERY = 2, 3
E2E_CRASH = (1, 5)  # (epoch, batch): the crash run's batcher raises there


def e2e_overrides(prof: dict, root: str, prefix: str, seed: int,
                  extra=()) -> list:
    """Overrides of the ``config`` preset for a run on the corpus: batch
    512, bf16, dropout 0.3 (the preset's), the table on, a rolling save
    every E2E_EVERY batches."""
    out = ["main.use_full=false", f"main.experiment_name_prefix={prefix}",
           f"main.seed={seed}"]
    for group, paths in prof.items():
        out += [f"main.small.{group}.{key}={value}"
                for key, value in paths.items()]
    return out + [f"main.small.paths.logs={root}/logs/",
                  f"train.batch_size={BATCH}",
                  f"train.num_epochs={E2E_EPOCHS}",
                  "tpu.device_image_cache=on",
                  f"tpu.checkpoint_every_steps={E2E_EVERY}", *extra]


def exp_dir_of(root: str, prefix: str) -> str:
    import glob

    found = glob.glob(f"{root}/logs/{prefix}_*")
    require(len(found) == 1, f"one experiment dir for {prefix}: {found}")
    return found[0]


def last_checkpoint(root: str, prefix: str) -> dict:
    import os

    with np.load(os.path.join(exp_dir_of(root, prefix), "last.ckpt")) as d:
        return {k: d[k] for k in d.files}


def device_idle_share(torch, prof, span: str, which: int) -> dict:
    """The device's idle share over the ``which``-th ``span`` of a trace:
    1 - (the union of CUDA kernel intervals inside it) / its length."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == span and e.device_type == DeviceType.CPU)
    require(len(spans) > which, f"{len(spans)} '{span}' spans in the trace")
    lo, hi = spans[which]
    # A user annotation (the span itself among them) has a device-side
    # copy covering the device work of its range: not a kernel.
    inside = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name != span
              and e.time_range.end > lo and e.time_range.start < hi]
    kernels = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                     for e in inside)
    # Device time by kind, summed over the events (overlaps count twice).
    kinds = {}
    for e in inside:
        kind = ("copies host to device" if "HtoD" in e.name
                else "copies device to host" if "DtoH" in e.name
                else "other copies and sets" if "Mem" in e.name
                else "kernels")
        kinds[kind] = kinds.get(kind, 0.0) + (
            min(e.time_range.end, hi) - max(e.time_range.start, lo)) / 1e6
    busy, cursor = 0.0, lo
    for start, end in kernels:
        start = max(start, cursor)
        if end > start:
            busy += end - start
            cursor = end
    require(busy > 0, f"no device kernel inside '{span}' {which}")
    return {"span_s": (hi - lo) / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1.0 - busy / (hi - lo), "device_s_by_kind": kinds}


def e2e_phase(torch, seed: int) -> tuple:
    """The port's train and eval journey at full width on a rendered
    corpus: ``dl_vqa_tpu_torch.main.main`` for E2E_EPOCHS epochs; the same
    run with a batcher that raises at E2E_CRASH; a third run resumed from
    that run's ``last.ckpt``, whose final state must equal the first run's
    (cuDNN deterministic for these runs); ``evaluate_vqa`` on the first
    run's best ``model.ckpt``, whose score must be the run's best. Then, not
    counted, the kernels held to the plain path at the corpus's shapes and
    the bare train step (:func:`e2e_parity`), and the epoch's time,
    samples/s and the device's idle share with the table on and off
    (:func:`e2e_timings`). Returns ``(launches, timings, the corpus's
    profile group)``."""
    import contextlib
    import os
    import shutil

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.data import pipeline
    from dl_vqa_tpu_torch.data.synthetic import make_synthetic_corpus
    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2
    from dl_vqa_tpu_torch.main import main as train_main
    from dl_vqa_tpu_torch.models.configs import ModelConfig

    wrappers = kernel_wrappers()
    root = os.path.abspath(E2E_DIR)
    shutil.rmtree(root, ignore_errors=True)
    phase_start = t0 = time.perf_counter()
    # The questions widened to the reference's vocab and length: the
    # model is the reference-parity model, T = SEQ_LEN.
    prof = make_synthetic_corpus(
        os.path.join(root, "corpus"), n_train=E2E_TRAIN, n_val=E2E_VAL,
        n_images=E2E_IMAGES, image_size=E2E_IMAGE_SIZE, max_answers=3000,
        seed=seed, learnable=True, n_val_images=E2E_VAL_IMAGES,
        question_tokens=ModelConfig().num_tokens, question_length=SEQ_LEN)
    corpus_s = time.perf_counter() - t0
    log(f"cnn_e2e: corpus of {E2E_TRAIN} + {E2E_VAL} questions over "
        f"{E2E_IMAGES} + {E2E_VAL_IMAGES} images at {E2E_IMAGE_SIZE} px in "
        f"{corpus_s:.1f} s")

    def compose(prefix, extra=()):
        return config_mod.compose(
            "config", e2e_overrides(prof, root, prefix, seed, extra))

    real_iter_epoch = pipeline.Batcher.iter_epoch

    def crashing_iter_epoch(self, epoch, start_batch=0):
        for i, batch in enumerate(real_iter_epoch(self, epoch, start_batch)):
            if self.shuffle and (epoch, start_batch + i) == E2E_CRASH:
                raise RuntimeError("cnn_e2e: the crash run's batcher fails")
            yield batch

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_launches(wrappers)
    runs = {}
    try:
        t0 = time.perf_counter()
        best = train_main(compose("e2e_straight"))
        runs["straight_s"] = time.perf_counter() - t0
        pipeline.Batcher.iter_epoch = crashing_iter_epoch
        try:
            train_main(compose("e2e_crash"))
            crashed = False
        except RuntimeError as e:
            crashed = "crash run's batcher" in str(e)
        finally:
            pipeline.Batcher.iter_epoch = real_iter_epoch
        require(crashed, "the crash run stops at its batcher's error")
        crash_ckpt = os.path.join(exp_dir_of(root, "e2e_crash"), "last.ckpt")
        t0 = time.perf_counter()
        resumed_best = train_main(compose("e2e_resumed", [
            "main.start_from_pretrained_model=true",
            f"main.small.paths.pretrained_model_path={crash_ckpt}"]))
        runs["resumed_s"] = time.perf_counter() - t0
        best_ckpt = os.path.join(exp_dir_of(root, "e2e_straight"),
                                 "model.ckpt")
        t0 = time.perf_counter()
        with open(os.path.join(root, "evaluate_stdout.txt"), "w") as out, \
                contextlib.redirect_stdout(out):
            score = evaluate_hw2(e2e_overrides(prof, root, "e2e_eval", seed, [
                f"main.small.paths.pretrained_model_path={best_ckpt}",
                "train.image.stride=1", "train.attention.do_option=+"]))
        runs["evaluate_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_launches(wrappers, "the cnn_e2e path")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # The crash run's last save was at the last multiple of E2E_EVERY
    # before the crash; the resumed run restarts there.
    crash_epoch, crash_batch = E2E_CRASH
    resume_batch = crash_batch // E2E_EVERY * E2E_EVERY
    with np.load(crash_ckpt) as d:
        meta = json.loads(bytes(d["__meta__"]).decode())
    require(meta.get("epoch") == crash_epoch
            and meta.get("batch_in_epoch") == resume_batch,
            f"the crash run's last save: {meta.get('epoch')}, "
            f"{meta.get('batch_in_epoch')}")
    straight, resumed = (last_checkpoint(root, p)
                         for p in ("e2e_straight", "e2e_resumed"))
    require(straight.keys() == resumed.keys(), "one layout of last.ckpt")
    resume_err = max(float(np.abs(resumed[k].astype(np.float64)
                                  - straight[k].astype(np.float64)).max())
                     for k in straight if k != "__meta__")
    finite = all(np.isfinite(v).all() for k, v in straight.items()
                 if k.startswith("params|"))
    log(f"cnn_e2e: best val score {best:.4f}, resumed run's {resumed_best:.4f}"
        f", evaluate_vqa on model.ckpt {score} | resumed final state vs "
        f"uninterrupted: max |diff| {resume_err:g} over {len(straight) - 1} "
        f"arrays (tol {TOL['e2e_resume']:g}) | runs {json.dumps(runs)}")
    log(f"cnn_e2e: kernel launches {json.dumps(launches)}")
    from dl_vqa_tpu_torch.data.dataset import VQADataset

    train_ds, val_ds = (
        VQADataset.load(VQADataset.cache_path(prof[split]["vqaDataset"]))
        for split in ("train_paths", "val_paths"))
    batches = -(-len(train_ds) // BATCH)
    require(train_ds.num_tokens == ModelConfig().num_tokens
            and train_ds.max_question_length == SEQ_LEN
            and val_ds.max_question_length == SEQ_LEN,
            f"the reference's vocab and length: {train_ds.num_tokens} ids, "
            f"T = {train_ds.max_question_length}, "
            f"{val_ds.max_question_length}")
    require(finite, "finite parameters after the cnn_e2e run")
    require(int(straight["step"]) == E2E_EPOCHS * batches,
            f"updates of the cnn_e2e run: {int(straight['step'])}")
    require(resume_err <= TOL["e2e_resume"],
            f"resumed vs uninterrupted final state: {resume_err}")
    require(abs(resumed_best - best) <= TOL["e2e_resume"],
            f"resumed best score {resumed_best} vs {best}")
    require(abs(score - best) <= TOL["e2e_eval_score"],
            f"evaluate_vqa {score} vs the loop's best {best}")

    # Grids each kernel launched: a train step runs kernel A once
    # (persistent) or a grid a timestep, kernel B a grid a timestep of the
    # batch, kernel 2 three grids, kernel C six, kernel 3 one; an eval
    # batch kernel 1 as A, kernel 2 three times, kernel 3 once.
    # Eval passes: each epoch of the first run, epoch 0 of the crash run,
    # the resumed epoch, and evaluate_vqa.
    steps = (E2E_EPOCHS * batches + (batches + crash_batch)
             + (batches - resume_batch))
    evals = -(-len(val_ds) // BATCH) * (E2E_EPOCHS + crash_epoch + 1 + 1)
    train_len, val_len = (train_ds.max_question_length,
                          val_ds.max_question_length)
    grids = recurrence_grids(torch)
    expected = {
        "lstm_recurrence_save": steps * (1 if grids == 1 else train_len),
        "lstm_backward_step": steps * train_len,
        "lstm_recurrence": evals * (1 if grids == 1 else val_len),
        "relu_maxpool": 3 * (steps + evals),
        "relu_maxpool_backward": 6 * steps,
        "attention_pool": steps + evals,
    }
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on the cnn_e2e path: {launches}, expected "
            f"{expected}")
    timings = e2e_parity(torch, seed, compose("e2e_parity"), train_ds,
                         val_ds, os.path.join(exp_dir_of(root, "e2e_straight"),
                                              "last.ckpt"))
    timings.update(e2e_timings(torch, compose, batches))
    timings.update(corpus_s=corpus_s, runs=runs, best_score=best,
                   evaluate_score=score, resume_max_abs_err=resume_err,
                   phase_s=time.perf_counter() - phase_start)
    return launches, timings, prof


def e2e_parity(torch, seed: int, cfg: dict, train_ds, val_ds,
               ckpt: str) -> dict:
    """The cnn_e2e path's kernels held against their plain versions at the
    shapes the loop gives them (launches not counted): from the straight
    run's final state (``ckpt``), one train step on the first batch of
    epoch 0 and the eval step on the first val batch, the images gathered
    from the device table by the batch's rows, each with the kernels and
    with ``plain_ops=True``. The loss to TOL["loss_bf16"] relative, the
    gradients per tensor to TOL["grads_bf16"] (the attention's to
    TOL["grads_bf16_attention"]); the eval score may move only by the
    samples whose two best plain logits lie within twice the largest
    logit difference, the only ones whose answer can change. Then the bare
    train step on that batch, by CUDA events."""
    from dl_vqa_tpu_torch.data.device_cache import plan_image_tables
    from dl_vqa_tpu_torch.data.pipeline import Batcher
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import (
        create_train_state, make_eval_step, make_train_step)
    from dl_vqa_tpu_torch.utils.checkpoint import restore_state

    model_cfg = ModelConfig.from_cfg(cfg["train"], train_ds.num_tokens)
    tables = plan_image_tables(cfg, {"train": train_ds, "val": val_ds},
                               "cuda")
    require(tables["train"] is not None and tables["val"] is not None,
            "the cnn_e2e corpus's device tables")

    def first_batch(ds, table, shuffle):
        batch = next(Batcher(ds, BATCH, shuffle=shuffle, seed=seed,
                             load_images=False).iter_epoch(0))
        return {**{k: torch.as_tensor(v).cuda() for k, v in batch.items()},
                "image_table": table}

    train_batch = first_batch(train_ds, tables["train"], True)
    val_batch = first_batch(val_ds, tables["val"], False)

    def restored():
        model = VqaNet(model_cfg, generator=torch.Generator().manual_seed(0))
        return restore_state(create_train_state(model, INITIAL_LR), ckpt)[0]

    out, grads, losses, evals, logits = {}, {}, {}, {}, {}
    for plain in (False, True):
        state = restored()
        _, metrics = make_train_step(model_cfg, plain_ops=plain)(
            state, train_batch, seed)
        losses[plain] = float(metrics["loss"])
        grads[plain] = {n: p.grad for n, p in state.model.named_parameters()
                        if p.grad is not None}
        loss, score = make_eval_step(model_cfg, plain_ops=plain)(
            state.model, val_batch)
        evals[plain] = (float(loss), float(score))
        with torch.no_grad():
            logits[plain] = state.model(
                val_batch["image_table"].index_select(
                    0, val_batch["image_rows"]),
                val_batch["questions"], val_batch["lengths"], train=False,
                compute_dtype=torch.bfloat16, plain_ops=plain).float()
    trained = [n for n, p in state.model.named_parameters()
               if p.requires_grad]
    require(list(grads[False]) == trained and list(grads[True]) == trained,
            "every trained tensor has a gradient")
    worst = ("", 0.0, 1.0)
    for n, want in grads[True].items():
        # The glimpse bias has gradient zero (a softmax ignores a shift).
        if n == "attention.x_conv.bias":
            continue
        tol = TOL["grads_bf16_attention" if n.startswith("attention.")
                  else "grads_bf16"]
        rel = rel_norm(grads[False][n], want)
        require(rel <= tol, f"cnn_e2e gradient of {n}: {rel} (tol {tol})")
        if rel / tol > worst[1] / worst[2]:
            worst = (n, rel, tol)
    logit_err = max_err(logits[False], logits[True])
    top2 = logits[True].topk(2, dim=1).values
    near = int(((top2[:, 0] - top2[:, 1]) <= 2 * logit_err).sum())
    (loss_k, score_k), (loss_p, score_p) = evals[False], evals[True]
    log(f"cnn_e2e kernel vs plain at the loop's shapes (B = {BATCH}, T = "
        f"{train_ds.max_question_length}, the corpus's lengths, bf16, "
        f"dropout 0.3): train loss {losses[False]:.6f} vs "
        f"{losses[True]:.6f} | gradients nearest their limit {worst[0]} at "
        f"{worst[1]:.3e} of its norm (tol {worst[2]:g}) | eval loss "
        f"{loss_k:.6f} vs {loss_p:.6f}, score {score_k:.3f} vs {score_p:.3f}"
        f" (logits max |diff| {logit_err:.3e}, {near} samples within twice "
        f"that of their runner-up)")
    for what, k, p in (("train", losses[False], losses[True]),
                       ("eval", loss_k, loss_p)):
        require(abs(k - p) <= TOL["loss_bf16"] * abs(p),
                f"cnn_e2e kernel vs plain {what} loss: {k} vs {p}")
    require(abs(score_k - score_p) <= near,
            f"cnn_e2e kernel vs plain eval score: {score_k} vs {score_p}, "
            f"{near} near ties")
    out["parity"] = {"train_loss": [losses[False], losses[True]],
                     "grads_worst": list(worst),
                     "eval_loss": [loss_k, loss_p],
                     "eval_score": [score_k, score_p],
                     "logits_max_abs_err": logit_err, "near_ties": near}
    del grads, logits

    state = restored()
    step = make_train_step(model_cfg)
    step_ms = timed(torch, lambda: step(state, train_batch, seed), iters=5)
    out["bare_step_ms"] = step_ms
    out["bare_step_samples_per_s"] = BATCH / step_ms * 1e3
    log(f"cnn_e2e timing: bare train step {step_ms:.3f} ms = "
        f"{BATCH / step_ms * 1e3:.1f} samples/s")
    return out


@contextlib.contextmanager
def recorded_scalars(scalars: dict):
    """Every scalar a TrainLogger reports while the block runs, appended
    under its tag in ``scalars``."""
    from dl_vqa_tpu_torch.utils.logger import TrainLogger

    report_scalars = TrainLogger.report_scalars

    def recording(self, values, epoch):
        for tag, value in values.items():
            scalars.setdefault(tag, []).append(float(value))
        report_scalars(self, values, epoch)

    TrainLogger.report_scalars = recording
    try:
        yield scalars
    finally:
        TrainLogger.report_scalars = report_scalars


def e2e_timings(torch, compose, batches: int) -> dict:
    """``dl_vqa_tpu_torch.main.main`` on the corpus with the table on and
    off (``train.save_model=false``; launches not counted), each under
    the profiler: epoch 1 of 2 gives the train pass's seconds and
    samples/s (the loop's throughput scalars, read as the logger reports
    them) and the device's idle share over that pass
    (``loop.EPOCH_SPAN``)."""
    from torch.profiler import ProfilerActivity, profile

    from dl_vqa_tpu_torch.main import main as train_main
    from dl_vqa_tpu_torch.train.loop import EPOCH_SPAN

    scalars = {}
    out = {}
    with recorded_scalars(scalars):
        for mode in ("on", "off"):
            scalars.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as trace:
                train_main(compose(f"e2e_timing_{mode}", [
                    "train.save_model=false", "tpu.checkpoint_every_steps=0",
                    f"tpu.device_image_cache={mode}"]))
                torch.cuda.synchronize()
            steps_per_s = scalars["Throughput/StepsPerSec"][1]
            samples_per_s = scalars["Throughput/QAPairsPerSecPerChip"][1]
            idle = device_idle_share(torch, trace, EPOCH_SPAN, 1)
            out[f"table_{mode}"] = {
                "epoch_s": batches / steps_per_s,
                "steps_per_s": steps_per_s,
                "samples_per_s": samples_per_s,
                "idle_share": idle["idle_share"],
                "span_s": idle["span_s"],
                "device_busy_s": idle["device_busy_s"],
                "device_s_by_kind": idle["device_s_by_kind"]}
            log(f"cnn_e2e timing, table {mode}: epoch 1 train pass "
                f"{out[f'table_{mode}']['epoch_s']:.3f} s = "
                f"{samples_per_s:.1f} samples/s; its span "
                f"{idle['span_s']:.3f} s, device busy "
                f"{idle['device_busy_s']:.3f} s, idle "
                f"{idle['idle_share']:.1%}; device s by kind "
                + json.dumps(idle["device_s_by_kind"]))
    return out


# Phase 16, online_e2e: the image data plane from JPEG files. cnn_e2e's
# questions over COCO-named copies of the committed fixtures (each id keeps
# the fixture it copies, so PIL's pixels of every row are known), the
# stores built from them, the CNN trained and evaluated on the JPEGs.
ONLINE_DIR = "online"  # under E2E_DIR
RATE_IMAGES = 256  # files of the COCO-sized fixture a decode rate times
TRACE_KERNELS = ("relu_maxpool_kernel", "relu_maxpool_backward",
                 "attention_pool_kernel", "lstm_backward_step", "lstm_")


def online_fixture_of(image_id: int) -> str:
    """The fixture an image id of the online corpus copies: ids 0, 1, 2
    modulo 8 the three small fixtures (4:2:2, progressive 4:4:4, grey), the
    rest the COCO-sized one."""
    from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
        LAYOUTS, LOAD_FIXTURE)

    others = [name for name in LAYOUTS if name != LOAD_FIXTURE]
    k = image_id % 8
    return others[k] if k < len(others) else LOAD_FIXTURE


def online_corpus(prof: dict, root: str) -> dict:
    """cnn_e2e's profile group with a JPEG directory a split (a copy of a
    fixture for every image id of the split's store) and the paths of the
    stores and dataset caches the phase builds: the online profile."""
    import os
    import shutil

    from dl_vqa_tpu_torch.data.dataset import store_ids
    from dl_vqa_tpu_torch.tools.make_serving_fixtures import FIXTURES

    base = prof["paths"]["base_path"]
    out_dir = os.path.join(root, ONLINE_DIR)
    os.makedirs(out_dir, exist_ok=True)
    online = {"paths": dict(prof["paths"])}
    for split in ("train_paths", "val_paths"):
        subtype = prof[split]["imgs"]
        image_dir = os.path.join(base, f"jpeg_{subtype}")
        os.makedirs(image_dir, exist_ok=True)
        for image_id in store_ids(prof[split]["processed_imgs"]).tolist():
            shutil.copyfile(
                os.path.join(FIXTURES, f"{online_fixture_of(image_id)}.jpg"),
                os.path.join(image_dir,
                             f"COCO_{subtype}_{image_id:012d}.jpg"))
        name = split.split("_")[0]
        online[split] = dict(
            prof[split], imgs=f"jpeg_{subtype}",
            processed_imgs=os.path.join(out_dir,
                                        f"processed_{name}_images.h5"),
            vqaDataset=os.path.join(out_dir, f"vqaDataset_{name}.npz"))
    return online


def hold_store(path: str, expected: dict) -> dict:
    """Every row of a built store against PIL's normalized pixels of the
    fixture its id copies, in uint8 levels of its channel: within
    TOL["decode_nvjpeg"] plus the fp16 store's half step (at most 2**-10
    of a value under 4: 0.06 of a level)."""
    from dl_vqa_tpu_torch.data.dataset import open_image_store, store_ids
    from dl_vqa_tpu_torch.data.images import (
        IMAGENET_STD, normalize_uint8_chw)

    features = open_image_store(path)
    ids = store_ids(path)
    want = {name: normalize_uint8_chw(pixels[None])[0]
            for name, pixels in expected.items()}
    level = (1.0 / (255.0 * IMAGENET_STD)).reshape(3, 1, 1)
    worst = {}
    for row, image_id in enumerate(ids.tolist()):
        name = online_fixture_of(image_id)
        levels = float((np.abs(np.asarray(features[row], np.float32)
                               - want[name]) / level).max())
        worst[name] = max(worst.get(name, 0.0), levels)
    limit = TOL["decode_nvjpeg"] + 0.0625
    require(max(worst.values()) <= limit,
            f"store {path} against PIL's pixels: {worst} levels "
            f"(tol {limit})")
    return {"rows": int(len(ids)), "max_levels_by_fixture": worst}


def decode_rates(paths, decoders) -> dict:
    """images/s of ``decode_image_files`` on ``paths`` (640x480 -> 224) by
    each decoder with 1, 4, 8 and ``os.cpu_count()`` threads, after a
    warm-up of each."""
    import os

    from dl_vqa_tpu_torch.data.images import decode_image_files

    out = {}
    for decoder in decoders:
        out[decoder] = {}
        for threads in sorted({1, 4, 8, os.cpu_count() or 1}):
            decode_image_files(paths[:2 * threads], 224, 0.875, decoder,
                               threads)
            t0 = time.perf_counter()
            decode_image_files(paths, 224, 0.875, decoder, threads)
            out[decoder][str(threads)] = len(paths) / (time.perf_counter()
                                                       - t0)
    return out


def trace_idle_share(path: str, span: str) -> dict:
    """A Chrome trace of ``torch.profiler`` (the loop's ``profile_dir``
    file): its kernel names, and the device's idle share over ``span``
    read as :func:`device_idle_share` reads a live trace (1 - the union of
    the card's kernels, copies and sets inside it / its length)."""
    with open(path) as fd:
        events = [e for e in json.load(fd)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == span and e.get("cat") == "user_annotation"]
    require(len(spans) == 1, f"one '{span}' span in {path}: {len(spans)}")
    lo, hi = spans[0]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e["ts"] + e["dur"] > lo and e["ts"] < hi]
    busy, cursor = 0.0, lo
    for start, end in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                             for e in device):
        start = max(start, cursor)
        if end > start:
            busy += end - start
            cursor = end
    names = sorted({e["name"] for e in device if e["cat"] == "kernel"})
    return {"span_s": (hi - lo) / 1e6, "device_busy_s": busy / 1e6,
            "idle_share": 1.0 - busy / (hi - lo), "kernel_names": names}


@contextlib.contextmanager
def recorded_evaluations(results: list):
    """The unrounded ``(score, loss, ...)`` of every eval pass
    ``evaluate_vqa`` runs while the block runs, appended to ``results``."""
    from dl_vqa_tpu_torch.train import loop

    evaluate = loop.evaluate

    def recording(*args, **kwargs):
        out = evaluate(*args, **kwargs)
        results.append(out)
        return out

    loop.evaluate = recording
    try:
        yield results
    finally:
        loop.evaluate = evaluate


def online_phase(torch, seed: int, prof: dict, e2e: dict) -> tuple:
    """Phase 16: the image data plane from JPEG files at full width.

    The stores of both splits built from the JPEG directories by
    ``preprocess_images(backend="auto")`` (nvJPEG on a host with no
    libjpeg), every row held to PIL's pixels (:func:`hold_store`); the
    loader's images/s; then, counted, ``main`` for E2E_EPOCHS epochs with
    ``tpu.online_images=true`` and ``tpu.profile_dir`` and ``evaluate_vqa``
    online on its best checkpoint; the trace of epoch 1 parsed for its
    kernels and the device's idle share; then, not counted,
    ``evaluate_vqa`` in f32 online and from the built store (the score to
    TOL["online_eval_score"], the loss to TOL["online_eval_loss"]), and
    two epochs from the built store with and without ``tpu.debug_nans``.
    Returns ``(launches, numbers)``."""
    import os

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.data.images import (
        coco_id_from_filename, decoder_for, list_jpgs, preprocess_images)
    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2
    from dl_vqa_tpu_torch.main import main as train_main
    from dl_vqa_tpu_torch.ops import _host
    from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
        LOAD_FIXTURE, load_expected)
    from dl_vqa_tpu_torch.train.loop import EPOCH_SPAN

    phase_start = time.perf_counter()
    root = os.path.abspath(E2E_DIR)
    online = online_corpus(prof, root)
    threads = os.cpu_count() or 1
    out = {"decoder": decoder_for("cuda"), "host_cpus": threads,
           "libjpeg_missing": _host.missing("image")}

    # The builder, as main builds a missing store.
    built = {}
    for split in ("train_paths", "val_paths"):
        lines = []
        t0 = time.perf_counter()
        n = preprocess_images(
            other_paths=online["paths"], data_paths=online[split],
            image_size=E2E_IMAGE_SIZE, central_fraction=0.875,
            processed_path=online[split]["processed_imgs"],
            log=lines.append, backend="auto", device="cuda")
        seconds = time.perf_counter() - t0
        built[split] = {"images": n, "s": seconds,
                        "images_per_s": n / seconds, "log": lines[0],
                        **hold_store(online[split]["processed_imgs"],
                                     load_expected())}
        require(out["decoder"] in lines[0], f"the builder's log names "
                f"{out['decoder']}: {lines[0]}")
    out["builder"] = built
    log(f"online_e2e builder: {json.dumps(built)}")

    image_dir = os.path.join(online["paths"]["base_path"],
                             online["train_paths"]["imgs"])
    coco = sorted(os.path.join(image_dir, f) for f in list_jpgs(image_dir)
                  if online_fixture_of(coco_id_from_filename(f))
                  == LOAD_FIXTURE)
    require(len(coco) >= RATE_IMAGES, f"{len(coco)} COCO-sized files")
    decoders = ["nvjpeg"] + (["libjpeg"] if out["libjpeg_missing"] is None
                             else [])
    out["decode_images_per_s"] = decode_rates(coco[:RATE_IMAGES], decoders)
    log(f"online_e2e loader images/s at 640x480 -> 224 by threads: "
        f"{json.dumps(out['decode_images_per_s'])} against the CNN train "
        f"step's {e2e['bare_step_samples_per_s']:.1f} samples/s")

    def compose(prefix, extra=()):
        return config_mod.compose(
            "config", e2e_overrides(online, root, prefix, seed, [
                f"main.num_workers={threads}", *extra]))

    # The counted path: the online run and its evaluation.
    trace_dir = os.path.join(root, ONLINE_DIR, "trace")
    wrappers = kernel_wrappers()
    scalars = {}
    reset_launches(wrappers)
    t0 = time.perf_counter()
    with recorded_scalars(scalars):
        best = train_main(compose("online_train", [
            "tpu.online_images=true", f"tpu.profile_dir={trace_dir}",
            "tpu.checkpoint_every_steps=0"]))
    run_s = time.perf_counter() - t0
    best_ckpt = os.path.join(exp_dir_of(root, "online_train"), "model.ckpt")
    eval_overrides = e2e_overrides(online, root, "online_eval", seed, [
        f"main.num_workers={threads}",
        f"main.small.paths.pretrained_model_path={best_ckpt}",
        "train.image.stride=1", "train.attention.do_option=+"])
    with open(os.path.join(root, ONLINE_DIR, "evaluate_stdout.txt"),
              "w") as stdout, contextlib.redirect_stdout(stdout):
        score = evaluate_hw2(eval_overrides + ["tpu.online_images=true"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, "the online_e2e path")
    batches = -(-E2E_TRAIN // BATCH)
    val_batches = -(-E2E_VAL // BATCH)
    steps, evals = E2E_EPOCHS * batches, val_batches * (E2E_EPOCHS + 1)
    grids = recurrence_grids(torch)
    expected = {
        "lstm_recurrence_save": steps * (1 if grids == 1 else SEQ_LEN),
        "lstm_backward_step": steps * SEQ_LEN,
        "lstm_recurrence": evals * (1 if grids == 1 else SEQ_LEN),
        "relu_maxpool": 3 * (steps + evals),
        "relu_maxpool_backward": 6 * steps,
        "attention_pool": steps + evals,
    }
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on the online_e2e path: {launches}, expected "
            f"{expected}")
    require(abs(score - best) <= TOL["e2e_eval_score"],
            f"online evaluate_vqa {score} vs the loop's best {best}")
    samples_per_s = scalars["Throughput/QAPairsPerSecPerChip"][1]
    traces = os.listdir(trace_dir)
    require(len(traces) == 1, f"one trace of epoch 1: {traces}")
    trace = trace_idle_share(os.path.join(trace_dir, traces[0]), EPOCH_SPAN)
    missing = [k for k in TRACE_KERNELS
               if not any(k in name for name in trace["kernel_names"])]
    require(not missing, f"the trace's kernels lack {missing}: "
            f"{trace['kernel_names']}")
    out["online_run"] = {
        "s": run_s, "best_score": best, "evaluate_score": score,
        "epoch1_samples_per_s": samples_per_s,
        "epoch1_s": batches / scalars["Throughput/StepsPerSec"][1],
        "bare_step_samples_per_s": e2e["bare_step_samples_per_s"],
        "table_on_samples_per_s": e2e["table_on"]["samples_per_s"],
        "trace_file": traces[0],
        "trace_bytes": os.path.getsize(os.path.join(trace_dir, traces[0])),
        **{k: v for k, v in trace.items() if k != "kernel_names"},
        "trace_kernels": len(trace["kernel_names"])}
    log(f"online_e2e: main online {E2E_EPOCHS} epochs in {run_s:.1f} s, "
        f"best {best:.4f}, evaluate_vqa online {score}; epoch 1 "
        f"{samples_per_s:.1f} samples/s (bare step "
        f"{e2e['bare_step_samples_per_s']:.1f}, table on "
        f"{e2e['table_on']['samples_per_s']:.1f}); its trace "
        f"{traces[0]}: span {trace['span_s']:.3f} s, device busy "
        f"{trace['device_busy_s']:.3f} s, idle {trace['idle_share']:.1%}")
    log(f"online_e2e: kernel launches {json.dumps(launches)}")

    # Not counted: online against the built store in f32, as the JAX
    # package's test holds its two pipelines.
    results = {}
    for mode, extra in (("online", ["tpu.online_images=true"]),
                        ("store", [])):
        evaluations = []
        with open(os.path.join(root, ONLINE_DIR, f"evaluate_{mode}.txt"),
                  "w") as stdout, contextlib.redirect_stdout(stdout), \
                recorded_evaluations(evaluations):
            evaluate_hw2(eval_overrides + ["tpu.compute_dtype=float32",
                                           *extra])
        require(len(evaluations) == 1, f"one eval pass: {evaluations}")
        results[mode] = evaluations[0][:2]
    (s_on, l_on), (s_store, l_store) = results["online"], results["store"]
    out["f32_eval"] = {"online": [s_on, l_on], "store": [s_store, l_store]}
    log(f"online_e2e evaluate_vqa in f32: online score {s_on!r} loss "
        f"{l_on!r}; built store score {s_store!r} loss {l_store!r}")
    require(abs(s_on - s_store) <= TOL["online_eval_score"],
            f"online vs store score: {s_on} vs {s_store}")
    require(abs(l_on - l_store) <= TOL["online_eval_loss"],
            f"online vs store loss: {l_on} vs {l_store}")

    # tpu.debug_nans on the clean corpus: no alarm; its step time.
    nans = {}
    for flag in ("false", "true"):
        scalars = {}
        with recorded_scalars(scalars):
            nans_best = train_main(compose(f"online_nans_{flag}", [
                "train.save_model=false", "tpu.checkpoint_every_steps=0",
                f"tpu.debug_nans={flag}"]))
        steps_per_s = scalars["Throughput/StepsPerSec"][1]
        nans[flag] = {"best_score": nans_best,
                      "epoch1_step_ms": 1e3 / steps_per_s,
                      "epoch1_samples_per_s":
                          scalars["Throughput/QAPairsPerSecPerChip"][1]}
    require(torch.is_anomaly_enabled() is False,
            "anomaly mode restored after the debug_nans run")
    out["debug_nans"] = nans
    log(f"online_e2e tpu.debug_nans on the built store, epoch 1: "
        f"{nans['true']['epoch1_step_ms']:.3f} ms a step with the flag, "
        f"{nans['false']['epoch1_step_ms']:.3f} without")
    out["phase_s"] = time.perf_counter() - phase_start
    return launches, out


# The serving front: the reference-parity model at full width,
# random weights from the seed saved as an npz checkpoint beside a
# vocab.json of 15,193 ids and 3,000 answers, served through the port's
# HTTP front, its native front and its predict CLI.
SERVING_DIR = "_smoke_serving"  # under the checkout; .gitignore lists it
SERVE_MAX_BATCH, SERVE_WINDOW_MS, SERVE_TOP_K = 64, 5.0, 5
# Closed loop: concurrency -> requests a client, each level several hundred
# requests (400, 480, 1,536) and dozens of batches; every request posts the
# COCO-sized fixture (load_bodies).
LOAD = {1: 400, 8: 60, 64: 24}
FORWARD_GRIDS = {"relu_maxpool": 3, "attention_pool": 1}  # a CNN batch


def serving_overrides(root: str, extra=()) -> list:
    """Overrides of ``config_eval`` that give ``ModelConfig()`` (stride 1,
    '+' fusion, dropout 0.3) on the checkpoint and vocab under ``root``."""
    return (["main.use_full=false",
             f"main.small.paths.vocab_path={root}/vocab.json",
             f"main.small.paths.pretrained_model_path={root}/model.npz",
             "train.image.stride=1", "train.attention.do_option=+"]
            + [f"train.{part}.dropout=0.3"
               for part in ("text", "image", "attention", "classifier")]
            + list(extra))


def fixture_requests():
    """``[(name, jpeg bytes, question)]``: each fixture with two
    questions."""
    import os

    from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
        FIXTURES, LAYOUTS)

    out = []
    for i, name in enumerate(LAYOUTS):
        with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as fd:
            raw = fd.read()
        for question in QUESTIONS[2 * i % len(QUESTIONS):][:2]:
            out.append((name, raw, question))
    return out


def load_bodies() -> list:
    """The closed loop's requests: the COCO-sized fixture (640x480, the
    pixels of a VQA 2.0 image) with each question of QUESTIONS."""
    import os

    from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
        FIXTURES, LOAD_FIXTURE)

    with open(os.path.join(FIXTURES, f"{LOAD_FIXTURE}.jpg"), "rb") as fd:
        raw = fd.read()
    return [request_body(raw, q) for q in QUESTIONS]


def request_body(raw: bytes, question: str) -> bytes:
    import base64

    return json.dumps({"image_b64": base64.b64encode(raw).decode(),
                       "question": question,
                       "top_k": SERVE_TOP_K}).encode()


def post(url: str, body: bytes) -> tuple:
    """``(status, payload)`` of one POST, within 60 s."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def get(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def post_all(url: str, bodies) -> list:
    """Every body posted at once, one thread each; the payloads in order."""
    import threading

    results = [None] * len(bodies)

    def one(i):
        results[i] = post(url, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for (status, payload), body in zip(results, bodies):
        require(status == 200, f"POST {url}: {status} {payload}")
    return [payload["answers"] for _, payload in results]


def load_client(url: str, bodies, concurrency: int, per_client: int):
    """Closed-loop clients, run in a process of their own (they take no
    share of the server's interpreter lock): ``concurrency`` threads, each
    sending ``per_client`` requests one after another. Returns ``(wall s,
    [latency ms], [status])``."""
    import threading

    latencies, statuses = [], []
    lock = threading.Lock()

    def client(i):
        for r in range(per_client):
            t0 = time.perf_counter()
            try:
                status, _ = post(url,
                                 bodies[(i * per_client + r) % len(bodies)])
            except OSError as exc:  # refused, reset, timed out: counted
                status = type(exc).__name__
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                latencies.append(ms)
                statuses.append(status)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, latencies, statuses


def percentile(values, q: float) -> float:
    """The serving fronts' own order statistic: sorted[int(q * n)]."""
    ordered = sorted(values)
    return float(ordered[min(len(ordered) - 1, int(q * len(ordered)))])


def hold_answers(answers, ref_probs, answer_by_id, what: str) -> float:
    """Served top-k ``[(answer, p)]`` against the reference's probabilities
    of every answer: each p within ``TOL["served_probs"]`` (relative) of the
    reference's for that answer, in descending order, and the reference's
    answer at each rank wherever its neighbours' probabilities differ from
    it by more than that. Returns the largest relative error."""
    tol = TOL["served_probs"]
    index = {a: i - 1 for i, a in answer_by_id.items()}
    order = np.argsort(-ref_probs, kind="stable")
    require(len(answers) == SERVE_TOP_K, f"{what}: top-{SERVE_TOP_K}")
    probs = [p for _, p in answers]
    require(probs == sorted(probs, reverse=True), f"{what}: descending")
    worst = 0.0
    for rank, (name, p) in enumerate(answers):
        want = float(ref_probs[index[name]])
        err = abs(p - want) / want
        worst = max(worst, err)
        require(err <= tol, f"{what}: {name} served {p}, reference {want}")
        here = ref_probs[order[rank]]
        above = ref_probs[order[rank - 1]] if rank else np.inf
        below = ref_probs[order[rank + 1]]
        if above - here > tol * here and here - below > tol * here:
            require(index[name] == order[rank],
                    f"{what}: rank {rank} served {name}, reference "
                    f"{answer_by_id[int(order[rank]) + 1]}")
    return worst


def decode_check(torch) -> dict:
    """The port's decoders on this host against PIL's pixels of the
    committed fixtures: nvJPEG (the decoder of a CUDA device on a host
    with no libjpeg) within TOL["decode_nvjpeg"] levels, and libjpeg,
    where the host has it, within TOL["decode_libjpeg"]; each one's time a
    fixture (median of 20, one thread), the COCO-sized one's as
    ``decode_ms_per_image``."""
    from dl_vqa_tpu_torch.data.images import decode_image, decoder_for
    from dl_vqa_tpu_torch.ops import _host
    from dl_vqa_tpu_torch.tools.make_serving_fixtures import (
        LAYOUTS, LOAD_FIXTURE, load_expected)

    expected = load_expected()
    raws = {name: raw for name, raw, _ in fixture_requests()}
    libjpeg_missing = _host.missing("image")
    decoders = ["nvjpeg"] + (["libjpeg"] if libjpeg_missing is None else [])
    out = {"serving_decoder": decoder_for("cuda"),
           "libjpeg_missing": libjpeg_missing}
    for decoder in decoders:
        per_fixture = {}
        for name, (w, h, _, _) in LAYOUTS.items():
            got = decode_image(raws[name], 224, 0.875, decoder)
            diff = np.abs(got.astype(np.int32) - expected[name])
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                decode_image(raws[name], 224, 0.875, decoder)
                times.append((time.perf_counter() - t0) * 1e3)
            per_fixture[name] = {"pixels": f"{w}x{h}",
                                 "bytes": len(raws[name]),
                                 "max": int(diff.max()),
                                 "mean": float(diff.mean()),
                                 "ms": float(np.median(times))}
            require(diff.max() <= TOL[f"decode_{decoder}"],
                    f"{decoder} decode of {name}: {per_fixture[name]}")
        ms = per_fixture[LOAD_FIXTURE]["ms"]
        log(f"decoder {decoder} on this host against PIL's pixels: "
            + ", ".join(f"{n} ({v['pixels']}, {v['bytes']} B) max "
                        f"{v['max']} mean {v['mean']:.3f} {v['ms']:.3f} ms"
                        for n, v in per_fixture.items()))
        out[decoder] = {"fixtures": per_fixture, "decode_ms_per_image": ms}
    out["nvjpeg"]["while_card_busy"] = nvjpeg_while_busy(
        torch, raws[LOAD_FIXTURE])
    return out


def nvjpeg_while_busy(torch, raw: bytes, threads: int = 3) -> dict:
    """Whether an nvJPEG decode waits for the model's work: a kernel that
    spins on the legacy default stream (the model's) for about 200 ms, and
    meanwhile ``threads`` decodes of ``raw`` at once, so that all but one
    take a decoder slot never used (its state, stream and buffers
    allocated). Returns the spin's ms and each decode's ms, ascending."""
    import threading

    from dl_vqa_tpu_torch.data.images import decode_image

    times = []

    def one():
        t0 = time.perf_counter()
        decode_image(raw, 224, 0.875, "nvjpeg")
        times.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(int(4e8))
    workers = [threading.Thread(target=one) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    torch.cuda.synchronize()
    spin = (time.perf_counter() - t0) * 1e3
    out = {"spin_ms": spin, "decode_ms": sorted(times)}
    log(f"nvJPEG decodes while the card spins {spin:.1f} ms on the default "
        f"stream: {', '.join(f'{t:.2f}' for t in sorted(times))} ms")
    return out


def make_serving_checkpoint(torch, seed: int, root: str) -> None:
    """``model.npz`` (random weights from the seed, ``ModelConfig()``) and
    ``vocab.json`` under ``root``, made afresh."""
    import os
    import shutil

    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.utils.checkpoint import save_params

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = ModelConfig()
    with open(os.path.join(root, "vocab.json"), "w") as fd:
        json.dump(make_vocab(cfg.num_tokens, cfg.max_answers), fd)
    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    save_params(os.path.join(root, "model.npz"), model, model_cfg=cfg,
                extra_meta={"max_question_length": SEQ_LEN})


def reference_probs(predictor, requests) -> np.ndarray:
    """``predictor``'s probabilities for the requests' decoded pixels and
    questions, in one batch: what the served answers are held to (run
    before a path's launches are counted)."""
    pixels = np.stack([predictor.preprocess_image(raw)
                       for _, raw, _ in requests])
    encoded, lengths = predictor.encode_questions([q for _, _, q in requests])
    return predictor.forward_probs(pixels, encoded, lengths)


def hold_served(predictor, requests, answers, ref, what: str) -> float:
    """Each served answer list against its row of ``ref``."""
    return max(hold_answers(top, row, predictor.answer_by_id,
                            f"{what} {name} {question!r}")
               for (name, _, question), top, row in zip(requests, answers,
                                                       ref))


def latency_levels(pool, bodies, start) -> dict:
    """Closed-loop load at each concurrency of LOAD: the clients' p50/p99
    and QA/s, the server's own p50/p99 and its mean batch. ``start()``
    readies the front for a level and returns ``(url, read)``; ``read()``
    after the level gives the server's ``{"p50", "p99", "batches",
    "requests"}`` for it."""
    out = {}
    for concurrency, per_client in LOAD.items():
        url, read = start()
        wall, lat, statuses = pool.apply(
            load_client, (url, bodies, concurrency, per_client))
        require(statuses == [200] * concurrency * per_client,
                f"closed loop at {concurrency}: statuses "
                f"{sorted(set(map(str, statuses)))}")
        server = read()
        out[concurrency] = {
            "requests": len(lat), "client_p50_ms": percentile(lat, 0.5),
            "client_p99_ms": percentile(lat, 0.99),
            "server_p50_ms": server["p50"], "server_p99_ms": server["p99"],
            "qa_per_s": len(lat) / wall, "batches": server["batches"],
            "mean_batch": server["requests"] / server["batches"]}
        log(f"  concurrency {concurrency}: {json.dumps(out[concurrency])}")
    return out


def predictor_latency(torch, predictor) -> dict:
    """``Predictor.forward_probs`` alone at B = 1, 8, 64 (uint8 host
    arrays in, probabilities on the host out): median ms of 20 after 3."""
    rng = np.random.default_rng(0)
    out = {}
    for b in LATENCY_BATCHES:
        images = rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
        encoded, lengths = predictor.encode_questions(
            [QUESTIONS[i % len(QUESTIONS)] for i in range(b)])
        times = []
        for i in range(23):
            t0 = time.perf_counter()
            predictor.forward_probs(images, encoded, lengths)
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        out[b] = float(np.median(times))
    return out


def serving_http_phase(torch, seed: int, pool, recurrence: int) -> tuple:
    """The Python front (``serve.build_server``, max_batch 64, window 5 ms)
    at full width: the fixtures posted at once, every answer held to the
    Predictor's forward of the same pixels; closed-loop clients posting
    the COCO-sized fixture at concurrency 1, 8 and 64 (``LOAD``); kernels
    1, 2 and 3 launched 1, 3 and 1 times
    a served batch over all of it (warmup excluded); the Predictor alone
    at B = 1, 8, 64. Then an int8 server calibrated on the fixtures, kernel
    D twice a batch. Returns ``({path: launches}, numbers, (the Python
    front's answers to the fixture requests, the Predictor's probabilities
    for them))``."""
    import dataclasses
    import os
    import threading

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch import serve
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.tools.make_serving_fixtures import FIXTURES

    wrappers = kernel_wrappers()
    root = os.path.abspath(SERVING_DIR)
    make_serving_checkpoint(torch, seed, root)
    requests = fixture_requests()
    bodies = [request_body(raw, q) for _, raw, q in requests]
    numbers, paths, python_answers = {}, {}, None
    for label, extra, cal in (
            ("serving_http", [], None),
            ("serving_http_int8", ["train.image.store_dtype=int8"],
             FIXTURES)):
        cfg = config_mod.compose("config_eval",
                                 serving_overrides(root, extra))
        t0 = time.perf_counter()
        httpd, service = serve.build_server(
            cfg, port=0, max_batch=SERVE_MAX_BATCH,
            batch_window_ms=SERVE_WINDOW_MS, int8_calibration_dir=cal)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            predictor = service.predictor
            start_s = time.perf_counter() - t0
            want_cfg = ModelConfig()
            if cal:
                scales = predictor.model_cfg.image.quant_scales
                require(len(scales) == len(want_cfg.image.num_channels) - 1,
                        "int8 scales from the fixtures, one a conv block")
                want_cfg = dataclasses.replace(want_cfg, image=dataclasses.
                                               replace(want_cfg.image,
                                                       store_dtype="int8",
                                                       quant_scales=scales))
            require(predictor.model_cfg == want_cfg,
                    f"{label}: the served model is ModelConfig(): "
                    f"{predictor.model_cfg}")
            t0 = time.perf_counter()
            service.warmup(block=True)
            warm_s = time.perf_counter() - t0
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            health = get(url + "/healthz")
            require(health["backend"] == "cuda", f"/healthz {health}")
            before = get(url + "/metrics")
            require(before["warmed_buckets"] == 7, f"warmup: {before}")
            ref = reference_probs(predictor, requests)
            reset_launches(wrappers)
            answers = post_all(url + "/v1/answer", bodies)
            worst = hold_served(predictor, requests, answers, ref, label)
            out = {"start_s": start_s, "warmup_s": warm_s,
                   "served_probs_max_rel_err": worst, "health": health}
            if not cal:
                def start():
                    with service.lock:
                        service.latencies_ms.clear()
                    at = service.metrics()

                    def read():
                        m = service.metrics()
                        return {"p50": m["latency_p50_ms"],
                                "p99": m["latency_p99_ms"],
                                "batches": m["batches"] - at["batches"],
                                "requests": m["batched_requests"]
                                - at["batched_requests"]}
                    return url + "/v1/answer", read

                log(f"{label}: closed-loop clients")
                out["load"] = latency_levels(pool, load_bodies(), start)
                python_answers = answers, ref
            torch.cuda.synchronize()
            launches = read_launches(wrappers, f"the {label} path")
            after = get(url + "/metrics")
            batches = after["batches"] - before["batches"]
            grids = ({"relu_maxpool_int8": 1, "conv_relu_pool_int8": 2,
                      "attention_pool": 1} if cal else FORWARD_GRIDS)
            expected = {"lstm_recurrence": recurrence * batches,
                        **{k: v * batches for k, v in grids.items()}}
            log(f"{label}: {len(bodies)} fixture requests answered (max "
                f"relative error of a probability {worst:.3e}, tol "
                f"{TOL['served_probs']:g}); {after['requests']} requests in "
                f"{batches} batches, kernel launches {json.dumps(launches)}")
            require(launches == {**dict.fromkeys(wrappers, 0), **expected},
                    f"kernel launches on {label}: {launches}, expected "
                    f"{expected} for {batches} batches")
            out["metrics"] = after
            if not cal:
                out["predictor_ms"] = predictor_latency(torch, predictor)
                log(f"{label}: Predictor.forward_probs alone, ms at B = "
                    f"1, 8, 64: {json.dumps(out['predictor_ms'])}")
            numbers[label], paths[label] = out, launches
        finally:
            service.stop()
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    return paths, numbers, python_answers


def serve_cli(root: str, extra=()):
    """``python -m dl_vqa_tpu_torch.serve [overrides] --port 0 [extra]`` as
    a process of its own: ``(process, url, stderr file)`` once it prints
    the line that names its port, url None when it exits first."""
    import os
    import queue
    import threading

    name = "serve_cli" + "".join(extra).replace("-", "_")
    err_path = os.path.join(root, f"{name}_stderr.txt")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dl_vqa_tpu_torch.serve", "--port", "0",
             "--no-warmup", *extra, *serving_overrides(root)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=err, text=True)
    lines: "queue.Queue" = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    deadline = time.perf_counter() + 300
    while time.perf_counter() < deadline:
        try:
            line = lines.get(timeout=max(deadline - time.perf_counter(), 0))
        except queue.Empty:
            break
        if line is None:
            proc.wait(timeout=60)
            return proc, None, err_path
        if line.startswith("serving on http://"):
            return proc, line.split()[2], err_path
    proc.kill()
    raise AssertionError(f"{name}: no port named in 300 s")


def serving_cli_phase(requests, ref, answer_by_id) -> dict:
    """The entry point as a user starts it: ``python -m
    dl_vqa_tpu_torch.serve ... --port 0`` answers the fixture requests,
    each held to the in-process Predictor's ``ref``; ``--native-front``
    does too where the host has libjpeg, and elsewhere exits nonzero
    naming ``jpeglib.h``."""
    import os

    from dl_vqa_tpu_torch.ops import _host

    root = os.path.abspath(SERVING_DIR)
    bodies = [request_body(raw, q) for _, raw, q in requests]
    out = {}
    for extra in ((), ("--native-front",)):
        label = "native" if extra else "http"
        t0 = time.perf_counter()
        proc, url, err_path = serve_cli(root, extra)
        try:
            if url is None:
                with open(err_path) as fd:
                    err = fd.read()
                require(bool(extra) and _host.missing("serve") is not None
                        and proc.returncode != 0 and "jpeglib.h" in err,
                        f"serve {' '.join(extra)} exited {proc.returncode}: "
                        f"{err[-2000:]}")
                out[label] = {"refused": err.strip().splitlines()[-1]}
                continue
            start_s = time.perf_counter() - t0
            answers = post_all(url + "/v1/answer", bodies)
            worst = max(hold_answers(top, row, answer_by_id,
                                     f"serve CLI {label} {name} {q!r}")
                        for (name, _, q), top, row in zip(requests, answers,
                                                         ref))
            out[label] = {"start_s": start_s,
                          "served_probs_max_rel_err": worst}
        finally:
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=60)
    log(f"serve CLI: {json.dumps(out)}")
    return out


def serving_native_phase(torch, seed: int, pool, recurrence: int,
                         python_answers: list) -> tuple:
    """The native front (``serve.build_native_server``) on the same
    checkpoint and requests, where the host has libjpeg: its answers held
    to the Python front's and to the Predictor's forward, the same closed
    loop (a fresh front a level, so that its latency window is the
    level's), kernels 1, 2 and 3 launched 1, 3 and 1 times a batch. Where
    the host has no libjpeg, the front must refuse to build and name what
    is missing (no other decoder stands in). Returns ``(launches or None,
    numbers)``."""
    import os

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch import serve
    from dl_vqa_tpu_torch.ops import _host
    from dl_vqa_tpu_torch.utils.native_front import NativeFrontService

    root = os.path.abspath(SERVING_DIR)
    cfg = config_mod.compose("config_eval", serving_overrides(root))
    missing = _host.missing("serve")
    if missing is not None:
        refused = None
        try:
            serve.build_native_server(cfg, port=0)
        except RuntimeError as exc:
            refused = str(exc)
        require(refused is not None and "jpeglib.h" in refused,
                f"the native front without libjpeg: {refused!r}")
        log(f"serving_native: blocked on this host ({missing}); "
            "build_native_server refuses and names it (ROADMAP item 8)")
        return None, {"blocked": missing}

    wrappers = kernel_wrappers()
    requests = fixture_requests()
    bodies = [request_body(raw, q) for _, raw, q in requests]
    fronts = [serve.build_native_server(
        cfg, port=0, max_batch=SERVE_MAX_BATCH,
        batch_window_ms=SERVE_WINDOW_MS)]
    predictor = fronts[0].predictor
    tol = 2 * TOL["served_probs"]
    try:
        fronts[0].start_dispatch()
        fronts[0].warmup(block=True)
        url = f"http://127.0.0.1:{fronts[0].port}"
        require(fronts[0].metrics()["warmed_buckets"] == 7, "warmup")
        batches_before = fronts[0].metrics()["batches"]
        ref = reference_probs(predictor, requests)
        reset_launches(wrappers)
        answers = post_all(url + "/v1/answer", bodies)
        worst = hold_served(predictor, requests, answers, ref,
                            "serving_native")
        for (name, _, q), mine, theirs in zip(requests, answers,
                                             python_answers):
            theirs = dict(theirs)
            for answer, p in mine:
                if answer in theirs:
                    require(abs(p - theirs[answer]) <= tol * theirs[answer],
                            f"native vs Python front, {name} {q!r}: "
                            f"{answer} {p} against {theirs[answer]}")
        batches = fronts[0].metrics()["batches"] - batches_before

        def start():
            fronts[-1].stop()
            fronts.append(NativeFrontService(
                predictor, port=0, max_batch=SERVE_MAX_BATCH,
                batch_window_ms=SERVE_WINDOW_MS))
            fronts[-1].start_dispatch()

            def read():
                m = fronts[-1].metrics()
                return {"p50": m["latency_p50_ms"], "p99": m["latency_p99_ms"],
                        "batches": m["batches"],
                        "requests": m["batched_requests"]}
            return f"http://127.0.0.1:{fronts[-1].port}/v1/answer", read

        log("serving_native: closed-loop clients")
        load = latency_levels(pool, load_bodies(), start)
        torch.cuda.synchronize()
        launches = read_launches(wrappers, "the serving_native path")
    finally:
        fronts[-1].stop()
    batches += sum(level["batches"] for level in load.values())
    expected = {"lstm_recurrence": recurrence * batches,
                **{k: v * batches for k, v in FORWARD_GRIDS.items()}}
    log(f"serving_native: {len(bodies)} fixture requests answered (max "
        f"relative error of a probability {worst:.3e}); {batches} batches, "
        f"kernel launches {json.dumps(launches)}")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on serving_native: {launches}, expected "
            f"{expected}")
    return launches, {"served_probs_max_rel_err": worst, "load": load}


def submission_phase(torch, seed: int, prof: dict) -> dict:
    """``python -m dl_vqa_tpu_torch.predict --submission`` as a subprocess
    on cnn_e2e's corpus and best checkpoint, with the device image table on
    and then off: one entry a val question in dataset order, the two files
    equal, and each answer the argmax of the eval forward (the model on the
    same batch of the val batcher, in this process)."""
    import os

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.data.dataset import load_or_build_val_dataset
    from dl_vqa_tpu_torch.data.pipeline import Batcher
    from dl_vqa_tpu_torch.predict import Predictor

    root = os.path.abspath(E2E_DIR)
    best_ckpt = os.path.join(exp_dir_of(root, "e2e_straight"), "model.ckpt")
    overrides = e2e_overrides(prof, root, "e2e_submission", seed, [
        f"main.small.paths.pretrained_model_path={best_ckpt}",
        "train.image.stride=1", "train.attention.do_option=+"])
    files, seconds = {}, {}
    for table in ("on", "off"):
        out = os.path.join(root, f"submission_{table}.json")
        t0 = time.perf_counter()
        with open(os.path.join(root, f"submission_{table}_stdout.txt"),
                  "w") as stdout:
            subprocess.run(
                [sys.executable, "-m", "dl_vqa_tpu_torch.predict",
                 "--submission", out, *overrides,
                 f"tpu.device_image_cache={table}"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=stdout, stderr=subprocess.STDOUT, timeout=600,
                check=True)
        seconds[table] = time.perf_counter() - t0
        with open(out) as fd:
            files[table] = json.load(fd)
    cfg = config_mod.compose("config_eval", overrides)
    val = load_or_build_val_dataset(cfg, cfg["main"]["small"])
    entries = files["on"]
    require(files["off"] == entries, "the submission with the table on "
            "and off")
    require([e["question_id"] for e in entries]
            == [int(q) for q in val.question_ids],
            f"{len(entries)} entries, one a val question in dataset order "
            f"({len(val)})")
    predictor = Predictor.from_config(cfg)
    argmax = []
    for batch in Batcher(val, cfg["train"]["batch_size"]):
        logits = predictor.forward_logits(batch["images"],
                                          batch["questions"],
                                          batch["lengths"])
        argmax += [predictor.answer_by_id.get(int(i) + 1, "<unk>")
                   for i, real in zip(logits.argmax(axis=1), batch["mask"])
                   if real]
    require([e["answer"] for e in entries] == argmax,
            "each answer is the argmax of the eval forward on its batch")
    log(f"submission: {len(entries)} answers, equal with the table on and "
        f"off, each the eval forward's argmax; subprocess wall s "
        f"{json.dumps(seconds)}")
    return {"entries": len(entries), "wall_s": seconds}


# The AOT serving artifact (dl_vqa_tpu_torch/utils/aot_export.py): the
# serving checkpoint exported through the predict CLI and served by a
# process that imports no model code, then four more exports in process.
AOT_DIR = "_smoke_aot"  # under the checkout; .gitignore lists it
AOT_BUCKETS = (1, 8, 64)
# Batches the fresh process answers: each bucket, 13 (padded to 64) and 77
# (split into 64, and 13 padded to 64).
AOT_REQUESTS = (1, 8, 64, 13, 77)
AOT_VARIANT_BATCH = 8
# What the process that serves an artifact must not import: the port's
# model code, config system, data plane, trainer and fronts, the JAX
# package, and what the port never imports.
AOT_FORBIDDEN = ("dl_vqa_tpu_torch.models", "dl_vqa_tpu_torch.config",
                 "dl_vqa_tpu_torch.data", "dl_vqa_tpu_torch.train",
                 "dl_vqa_tpu_torch.predict", "dl_vqa_tpu_torch.serve",
                 "dl_vqa_tpu", "jax", "yaml", "PIL")
DISPATCH_CALLS = 200  # calls a side when an op's dispatch cost is timed


def aot_requests(cfg, seed: int) -> dict:
    """``{n: (images, questions, lengths)}`` for AOT_REQUESTS: normalised
    f32 images, question ids and lengths 0 .. T (the artifact clamps 0 to
    1), from a seed."""
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
                rng.integers(0, cfg.num_tokens, (n, SEQ_LEN)).astype(np.int32),
                rng.integers(0, SEQ_LEN + 1, n).astype(np.int32))
            for n in AOT_REQUESTS}


def artifact_blocks(images, questions, lengths, buckets) -> list:
    """The artifact's batching contract, written out here: blocks of the
    largest bucket, the rest padded with zero rows up to the nearest
    bucket, every length at least 1. ``[(rows taken, (images, questions,
    lengths))]``: the inputs each exported call gets."""
    blocks, start, n = [], 0, len(images)
    while start < n:
        bs = min([b for b in buckets if b >= n - start],
                 default=max(buckets))
        take = min(bs, n - start)

        def pad(x):
            x = x[start:start + take]
            return np.concatenate(
                [x, np.zeros((bs - take,) + x.shape[1:], x.dtype)])

        blocks.append((take, (pad(images), pad(questions),
                              np.maximum(pad(lengths), 1))))
        start += take
    return blocks


def live_logits(predictor, request, buckets) -> np.ndarray:
    """``Predictor.forward_logits`` on each block the artifact runs."""
    return np.concatenate([predictor.forward_logits(*arrays)[:take]
                           for take, arrays in artifact_blocks(*request,
                                                               buckets)])


def forward_grids(recurrence: int, grids: dict) -> dict:
    return {"lstm_recurrence": recurrence, "attention_pool": 1, **grids}


def aot_client(artifact_dir: str, requests_path: str, out: str) -> int:
    """The aot phase's fresh process (``chip_smoke.py --aot-client DIR
    REQUESTS OUT``): loads the artifact on the card with
    ``utils.aot_export.load_artifact``, names every module of AOT_FORBIDDEN
    it imported (there must be none), then answers each batch of
    REQUESTS (an npz) with the kernels' launches counted from 0 before
    each; writes the logits to ``OUT.npz`` and the rest to ``OUT.json``
    (``start_s``: from before the CUDA context to the loaded artifact,
    ``context_s`` of it the context)."""
    import torch

    from dl_vqa_tpu_torch.utils.aot_export import load_artifact

    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")  # the CUDA context
    torch.cuda.synchronize()
    context_s = time.perf_counter() - t0
    artifact = load_artifact(artifact_dir)
    torch.cuda.synchronize()
    start_s = time.perf_counter() - t0
    forbidden = sorted(m for m in sys.modules if any(
        m == p or m.startswith(p + ".") for p in AOT_FORBIDDEN))
    wrappers = kernel_wrappers()
    logits, launches = {}, {}
    with np.load(requests_path) as z:
        for n in AOT_REQUESTS:
            request = [z[f"{key}{n}"]
                       for key in ("images", "questions", "lengths")]
            reset_launches(wrappers)
            logits[f"b{n}"] = artifact.logits(*request)
            torch.cuda.synchronize()
            launches[n] = read_launches(wrappers, f"the artifact at B = {n}")
    np.savez(out + ".npz", **logits)
    with open(out + ".json", "w") as fd:
        json.dump({"start_s": start_s, "context_s": context_s,
                   "forbidden": forbidden,
                   "launches": launches,
                   "device": torch.cuda.get_device_name(0)}, fd)
    return 0


def hold_bits(got, want, what: str) -> float:
    """The artifact's logits against the live Predictor's: finite, and
    within TOL["aot_logits"] (0: the same bits)."""
    require(got.shape == want.shape and np.isfinite(got).all(),
            f"{what}: logits {got.shape}, finite, as the Predictor's "
            f"{want.shape}")
    err = float(np.abs(got.astype(np.float64) - want).max())
    require(err <= TOL["aot_logits"],
            f"{what}: the artifact's logits against the Predictor's: max "
            f"|diff| {err:g} (tol {TOL['aot_logits']:g})")
    return err


def opcheck_cases(torch, gen) -> list:
    """``[(op, label, args, direct)]``: each ``vqa::`` op on CUDA inputs at
    a small shape and at its serving shape (B = 1, the reference-parity
    model and the ViT at full width), with the kernel wrapper the op's
    CUDA registration calls (``direct``, args as the op takes them)."""
    from dl_vqa_tpu_torch.ops import conv_fused, conv_int8, vit_mlp_fused
    from dl_vqa_tpu_torch.ops.attention_pool import attention_pool_cuda
    from dl_vqa_tpu_torch.ops.lstm_cuda import (
        lstm_recurrence_cuda, lstm_token_states_cuda)
    from dl_vqa_tpu_torch.ops.vit_attention import vit_attention_cuda

    def token_states(*args):  # the op's two outputs of the wrapper's five
        _, c, _, _, h_all = lstm_token_states_cuda(*args)
        return h_all, c

    def r(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def codes(*shape):
        return torch.randint(0, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    bf = torch.bfloat16
    lengths = torch.tensor([5, 1, 3], dtype=torch.int32, device="cuda")
    cases = [
        ("lstm_recurrence", "small f32",
         (r(2, 5, 3, 64), r(2, 64, 16, scale=0.2), lengths),
         lstm_recurrence_cuda),
        ("lstm_recurrence", "B = 1 bf16",
         (r(2, SEQ_LEN, 1, 4 * HIDDEN, dtype=bf),
          r(2, 4 * HIDDEN, HIDDEN, dtype=bf, scale=0.03),
          torch.tensor([17], dtype=torch.int32, device="cuda")),
         lstm_recurrence_cuda),
        ("lstm_token_states", "small f32",
         (r(2, 5, 3, 64), r(2, 64, 16, scale=0.2), lengths), token_states),
        ("lstm_token_states", "B = 1 f32",
         (r(2, SEQ_LEN, 1, 4 * HIDDEN),
          r(2, 4 * HIDDEN, HIDDEN, scale=0.03),
          torch.tensor([17], dtype=torch.int32, device="cuda")),
         token_states),
        ("attention_pool", "small f32", (r(2, 4, 4, 8), r(2, 4, 4, 2)),
         attention_pool_cuda),
        ("attention_pool", "B = 1 f32",
         (r(1, 26, 26, 256), r(1, 26, 26, 2)), attention_pool_cuda),
        ("vit_attention", "small bf16", (r(2, 10, 192, dtype=bf), 1),
         vit_attention_cuda),
        ("vit_attention", "B = 1 bf16",
         (r(1, VIT_TOKENS, 3 * VIT_WIDTH, dtype=bf), VIT_HEADS),
         vit_attention_cuda),
        ("conv_relu_pool_fused", "small bf16",
         (r(2, 12, 12, 16, dtype=bf), r(32, 16, 3, 3, scale=0.1), r(32)),
         conv_fused.conv_relu_pool_fused_cuda),
        ("conv_relu_pool_fused", "B = 1 bf16",
         (r(1, 111, 111, 64, dtype=bf), r(128, 64, 3, 3, scale=0.05),
          r(128)), conv_fused.conv_relu_pool_fused_cuda),
        ("conv_relu_pool_stem", "small bf16",
         (r(2, 12, 12, 3, dtype=bf), r(8, 3, 3, 3, scale=0.2), r(8)),
         conv_fused.conv_relu_pool_stem_cuda),
        ("conv_relu_pool_stem", "B = 1 bf16",
         (r(1, 224, 224, 3, dtype=bf), r(64, 3, 3, 3, scale=0.2), r(64)),
         conv_fused.conv_relu_pool_stem_cuda),
        ("fused_ln_mlp", "small bf16",
         (r(2, 5, 64, dtype=bf), r(64), r(64), r(128, 64, scale=0.1),
          r(128), r(64, 128, scale=0.1), r(64)),
         vit_mlp_fused.fused_ln_mlp_cuda),
        ("fused_ln_mlp", "B = 1 bf16",
         (r(1, VIT_TOKENS, VIT_WIDTH, dtype=bf), r(VIT_WIDTH), r(VIT_WIDTH),
          r(VIT_HIDDEN, VIT_WIDTH, scale=0.05), r(VIT_HIDDEN),
          r(VIT_WIDTH, VIT_HIDDEN, scale=0.03), r(VIT_WIDTH)),
         vit_mlp_fused.fused_ln_mlp_cuda),
        ("conv_relu_pool_w8a8", "small",
         (codes(2, 10, 10, 8), 2.0, r(32, 8, 3, 3, scale=0.2), r(32), 1,
          40.0), conv_int8.conv_relu_pool_w8a8_cuda),
        ("conv_relu_pool_w8a8", "B = 1",
         (codes(1, 111, 111, 64), 2.0, r(128, 64, 3, 3, scale=0.05),
          r(128), 1, 40.0), conv_int8.conv_relu_pool_w8a8_cuda),
    ]
    for label, y in (("small bf16", r(2, 9, 8, 16, dtype=bf)),
                     ("B = 1 bf16", r(1, 222, 222, 64, dtype=bf))):
        bias = r(y.shape[-1])
        for mode, direct in (
                ("compute", lambda y, b, m, s: conv_fused.relu_maxpool_cuda(
                    y, b)),
                ("e4m3", lambda y, b, m, s: conv_fused.relu_maxpool_e4m3_cuda(
                    y, b)),
                ("int8", lambda y, b, m, s: conv_fused.quantize_relu_pool_cuda(
                    y, b, s))):
            cases.append(("relu_maxpool", f"{label} {mode}",
                          (y, bias, mode, 3.0), direct))
    return cases


def host_us(torch, fn, calls: int) -> float:
    """µs of host time a call of ``fn`` takes to enqueue its work (the
    device is not waited for inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def op_checks(torch, seed: int) -> dict:
    """``torch.library.opcheck`` of every ``vqa::`` op on CUDA inputs at a
    small and at its serving shape, each test passing; then, at the B = 1
    shapes, each op called through ``torch.ops.vqa`` against its kernel
    wrapper called directly on the same inputs, under
    ``torch.inference_mode()`` as the Predictor and the artifact call
    them: host µs to enqueue a call (in turns: op, wrapper, wrapper, op)
    and µs a call by CUDA events (timed_turns), outputs equal to the
    bit."""
    from torch.library import opcheck

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = opcheck_cases(torch, gen)
    checked = {}
    for name, label, args, _ in cases:
        result = opcheck(getattr(torch.ops.vqa, name).default, args)
        require(all(v == "SUCCESS" for v in result.values()),
                f"opcheck vqa::{name} ({label}): {result}")
        checked.setdefault(name, []).append(label)
    require(set(checked) == {
        "lstm_recurrence", "lstm_token_states", "relu_maxpool",
        "attention_pool", "vit_attention",
        "conv_relu_pool_fused", "conv_relu_pool_stem", "fused_ln_mlp",
        "conv_relu_pool_w8a8"}, f"opcheck covers every op: {sorted(checked)}")
    log(f"opcheck: every vqa:: op passes at {sum(map(len, checked.values()))}"
        f" shapes: {json.dumps(checked)}")
    dispatch = {}
    for name, label, args, direct in cases:
        if "B = 1" not in label:
            continue
        op = getattr(torch.ops.vqa, name)
        a, b = op(*args), direct(*args)
        require(all(torch.equal(x, y) for x, y in zip(
            a if isinstance(a, tuple) else (a,),
            b if isinstance(b, tuple) else (b,))),
                f"vqa::{name} ({label}) against its wrapper: the same bits")
        with torch.inference_mode():
            turns = [host_us(torch, fn, DISPATCH_CALLS) for fn in (
                lambda: op(*args), lambda: direct(*args),
                lambda: direct(*args), lambda: op(*args))]
            op_ms, direct_ms = timed_turns(
                torch, [lambda: op(*args), lambda: direct(*args)], 50)
        entry = {"op_host_us": (turns[0] + turns[3]) / 2,
                 "direct_host_us": (turns[1] + turns[2]) / 2,
                 "op_device_us": op_ms * 1e3,
                 "direct_device_us": direct_ms * 1e3}
        entry["dispatch_us"] = entry["op_host_us"] - entry["direct_host_us"]
        dispatch[f"{name} {label}"] = entry
        log(f"dispatch vqa::{name} ({label}): {json.dumps(entry)}")
    return {"opcheck": checked, "dispatch_b1": dispatch}


def aot_phase(torch, seed: int, recurrence: int) -> tuple:
    """The serving checkpoint of phase 11 (``_smoke_serving/``, the
    reference-parity model in bf16) exported by ``python -m
    dl_vqa_tpu_torch.predict --export-artifact`` at the buckets AOT_BUCKETS;
    a fresh process (:func:`aot_client`) loads it, imports none of
    AOT_FORBIDDEN, answers AOT_REQUESTS with kernels 1, 2, 3 launched 1, 3,
    1 times a bucket call, and its logits are the live Predictor's on the
    same blocks (TOL["aot_logits"]). In this process: the artifact's
    forward against the live Predictor's at each bucket, in turns; then
    exports at B = AOT_VARIANT_BATCH of the ViT with ``fused_ops`` (kernels
    4, 8), the CNN with ``fused_ops`` (7, 6), the f8 store (kernel 2's
    e4m3 mode) and the int8 stem calibrated by ``Predictor.calibrate_int8``
    (kernel 2's int8 mode, D), each program's launches and logits held
    likewise; every ``vqa::`` op through ``opcheck`` (:func:`op_checks`).
    Returns ``({path: launches}, numbers)``."""
    import os
    import shutil

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.predict import Predictor
    from dl_vqa_tpu_torch.utils.aot_export import load_artifact

    wrappers = kernel_wrappers()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(AOT_DIR)
    serving = os.path.abspath(SERVING_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    phase_start = time.perf_counter()
    cnn_dir = os.path.join(root, "cnn")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dl_vqa_tpu_torch.predict",
         "--export-artifact", cnn_dir, "--export-batch-sizes",
         ",".join(map(str, AOT_BUCKETS)), *serving_overrides(serving)],
        cwd=here, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0,
            f"the export CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    numbers = {"export_cli_s": time.perf_counter() - t0,
               "export_s": json.loads(
                   proc.stdout.strip().splitlines()[-1])["export_seconds"]}
    files = {name: os.path.getsize(os.path.join(cnn_dir, name))
             for name in sorted(os.listdir(cnn_dir))}
    require(sorted(files) == sorted(
        [f"forward_b{b}.pt2" for b in AOT_BUCKETS]
        + ["meta.json", "params.npz"]), f"the artifact's files: {files}")
    numbers["bytes"] = files
    # What the program runs besides the live forward's ops: export guards
    # each .to() with an assert node.
    graph = torch.export.load(os.path.join(
        cnn_dir, f"forward_b{AOT_BUCKETS[0]}.pt2")).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    numbers["graph_ops"] = {
        "call_function": len(targets),
        "assert_tensor_metadata": sum(
            t == "aten._assert_tensor_metadata.default" for t in targets),
        "vqa": sum(t.startswith("vqa.") for t in targets)}

    cfg = config_mod.compose("config_eval", serving_overrides(serving))
    predictor = Predictor.from_config(cfg)
    requests = aot_requests(predictor.model_cfg, seed)
    requests_path = os.path.join(root, "requests.npz")
    np.savez(requests_path, **{
        f"{key}{n}": array for n, request in requests.items()
        for key, array in zip(("images", "questions", "lengths"), request)})
    out = os.path.join(root, "client")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--aot-client", cnn_dir,
         requests_path, out], cwd=here, capture_output=True, text=True,
        timeout=600)
    require(proc.returncode == 0, f"the artifact's process exited "
            f"{proc.returncode}: {proc.stderr[-3000:]}")
    with open(out + ".json") as fd:
        client = json.load(fd)
    require(client["forbidden"] == [],
            f"the artifact's process imported {client['forbidden']}")
    numbers["loader_start_s"] = client["start_s"]
    numbers["loader_context_s"] = client["context_s"]
    total = dict.fromkeys(wrappers, 0)
    errs = {}
    with np.load(out + ".npz") as got:
        for n, request in requests.items():
            calls = len(artifact_blocks(*request, AOT_BUCKETS))
            expected = {k: v * calls for k, v in forward_grids(
                recurrence, FORWARD_GRIDS).items()}
            launches = client["launches"][str(n)]
            require(launches == {**dict.fromkeys(wrappers, 0), **expected},
                    f"the artifact at B = {n} ({calls} calls): launches "
                    f"{launches}, expected {expected}")
            total = {k: total[k] + launches[k] for k in total}
            errs[n] = hold_bits(got[f"b{n}"],
                                live_logits(predictor, request, AOT_BUCKETS),
                                f"the exported CNN at B = {n}")
    log(f"aot: the CLI exported B = {AOT_BUCKETS} in "
        f"{json.dumps(numbers['export_s'])} s; a process with none of the "
        f"model code loaded it in {client['start_s']:.2f} s (the CUDA "
        f"context {client['context_s']:.2f} s of it) and answered B "
        f"= {AOT_REQUESTS}: logits max |diff| from the Predictor's "
        f"{json.dumps(errs)}, kernel launches {json.dumps(total)}")
    paths = {"aot_cnn": total}

    artifact = load_artifact(cnn_dir)
    numbers["forward_ms"] = {}
    for n in AOT_BUCKETS:
        images, questions, lengths = requests[n]
        lengths = np.maximum(lengths, 1)
        art_ms, live_ms = timed_turns(torch, [
            lambda: artifact.logits(images, questions, lengths),
            lambda: predictor.forward_logits(images, questions, lengths)], 20)
        numbers["forward_ms"][n] = {"artifact": art_ms, "predictor": live_ms}
    log(f"aot: forward ms, the artifact against the live Predictor (host "
        f"arrays in, logits on the host out): "
        f"{json.dumps(numbers['forward_ms'])}; the program's ops "
        f"{json.dumps(numbers['graph_ops'])}")

    vit_model = VqaNet(vit_config(), device="cuda",
                       generator=torch.Generator().manual_seed(seed))
    vit = Predictor(vit_config(), vit_model,
                    make_vocab(vit_config().num_tokens,
                               vit_config().max_answers),
                    device="cuda", max_question_length=SEQ_LEN,
                    compute_dtype=torch.bfloat16, fused_ops=True)
    cnn_fused = Predictor.from_config(cfg)
    cnn_fused.fused_ops = True
    f8, int8 = (Predictor.from_config(config_mod.compose(
        "config_eval", serving_overrides(
            serving, [f"train.image.store_dtype={store}"])))
        for store in ("f8e4m3", "int8"))
    int8.calibrate_int8(np.random.default_rng(seed).integers(
        0, 256, (CALIBRATION_IMAGES, 224, 224, 3), dtype=np.uint8))
    vit_layers = vit_config().image.num_layers
    variants = (
        ("vit_fused", vit, {"vit_attention": vit_layers,
                            "vit_mlp_fused": 2 * vit_layers}),
        ("cnn_fused", cnn_fused, {"conv_relu_pool_stem": 1,
                                  "conv_relu_pool_fused": 2}),
        ("cnn_f8", f8, {"relu_maxpool_e4m3": 3}),
        ("cnn_int8", int8, {"relu_maxpool_int8": 1,
                            "conv_relu_pool_int8": 2}))
    request = requests[AOT_VARIANT_BATCH]
    request = (*request[:2], np.maximum(request[2], 1))
    numbers["variants"] = {}
    for name, live, grids in variants:
        path = os.path.join(root, name)
        seconds = live.export_artifact(path, batch_sizes=(AOT_VARIANT_BATCH,))
        exported = load_artifact(path)
        want = live.forward_logits(*request)
        reset_launches(wrappers)
        got = exported.logits(*request)
        torch.cuda.synchronize()
        launches = read_launches(wrappers, f"the exported {name}")
        expected = forward_grids(recurrence, grids)
        require(launches == {**dict.fromkeys(wrappers, 0), **expected},
                f"the exported {name}: launches {launches}, expected "
                f"{expected}")
        err = hold_bits(got, want, f"the exported {name}")
        numbers["variants"][name] = {
            "export_s": seconds[AOT_VARIANT_BATCH], "max_abs_err": err,
            "meta": {k: exported.meta[k] for k in (
                "compute_dtype", "fused_ops", "store_dtype",
                "quant_scales")}}
        paths[f"aot_{name}"] = launches
        log(f"aot {name}: exported at B = {AOT_VARIANT_BATCH} in "
            f"{seconds[AOT_VARIANT_BATCH]:.2f} s, logits max |diff| {err:g}"
            f", kernel launches {json.dumps(launches)}")
    served = {k for counts in paths.values() for k, v in counts.items() if v}
    require({"lstm_recurrence", "relu_maxpool", "relu_maxpool_e4m3",
             "relu_maxpool_int8", "attention_pool", "vit_attention",
             "conv_relu_pool_fused", "conv_relu_pool_stem", "vit_mlp_fused",
             "conv_relu_pool_int8"} <= served,
            f"every serving op launched from an exported program: {served}")
    numbers.update(op_checks(torch, seed))
    numbers["phase_s"] = time.perf_counter() - phase_start
    return paths, numbers


# The sweep: multirun_main over two learning rates on cnn_e2e's corpus,
# one epoch a trial, the device table on.
SWEEP_SPACE = "train.lr.lr_value=5.0e-4,1.0e-3"


def sweep_phase(torch, seed: int, prof: dict) -> tuple:
    """``dl_vqa_tpu_torch.main.multirun_main`` over SWEEP_SPACE on the
    cnn_e2e corpus (batch 512, bf16, 1 epoch a trial, the table on, no
    rolling save): the default trial (``sweep.trial_runner``) wrapped to
    count each trial's launches from 0. Two trials, each launching kernels
    1, A, B, 2, C and 3 exactly as its steps and eval batches ask; the
    returned best is the larger of the trials' best accuracies. Returns
    ``(launches of both trials, numbers)``."""
    import os

    from dl_vqa_tpu_torch.data.dataset import VQADataset
    from dl_vqa_tpu_torch.main import multirun_main
    from dl_vqa_tpu_torch.sweep import trial_runner

    wrappers = kernel_wrappers()
    root = os.path.abspath(E2E_DIR)
    trial = trial_runner("config", "cuda")
    trials = []

    def counted(overrides):
        reset_launches(wrappers)
        t0 = time.perf_counter()
        value = trial(overrides)
        torch.cuda.synchronize()
        trials.append({
            "lr": [o for o in overrides if o.startswith("train.lr.")][-1],
            "best_accuracy": value, "s": time.perf_counter() - t0,
            "launches": read_launches(wrappers,
                                      f"sweep trial {len(trials)}")})
        return value

    t0 = time.perf_counter()
    best = multirun_main("config", [SWEEP_SPACE, *e2e_overrides(
        prof, root, "e2e_sweep", seed,
        ["train.num_epochs=1", "tpu.checkpoint_every_steps=0"])],
        runner=counted)
    sweep_s = time.perf_counter() - t0
    train_ds, val_ds = (
        VQADataset.load(VQADataset.cache_path(prof[split]["vqaDataset"]))
        for split in ("train_paths", "val_paths"))
    steps = -(-len(train_ds) // BATCH)
    evals = -(-len(val_ds) // BATCH)
    grids = recurrence_grids(torch)
    expected = {
        "lstm_recurrence_save": steps * (1 if grids == 1 else SEQ_LEN),
        "lstm_backward_step": steps * SEQ_LEN,
        "lstm_recurrence": evals * (1 if grids == 1 else SEQ_LEN),
        "relu_maxpool": 3 * (steps + evals),
        "relu_maxpool_backward": 6 * steps,
        "attention_pool": steps + evals}
    require(len(trials) == 2 and trials[0]["lr"] != trials[1]["lr"],
            f"two trials, one a learning rate: {trials}")
    for t in trials:
        require(t["launches"] == {**dict.fromkeys(wrappers, 0), **expected},
                f"sweep trial {t['lr']}: launches {t['launches']}, expected "
                f"{expected}")
    require(best == max(t["best_accuracy"] for t in trials),
            f"multirun_main's best {best} against its trials' "
            f"{[t['best_accuracy'] for t in trials]}")
    log(f"sweep: {len(trials)} trials in {sweep_s:.1f} s, best {best:.4f}: "
        + "; ".join(f"{t['lr']} -> {t['best_accuracy']:.4f} in "
                    f"{t['s']:.1f} s" for t in trials)
        + f" | kernel launches a trial {json.dumps(expected)}")
    launches = {k: sum(t["launches"][k] for t in trials) for k in wrappers}
    return launches, {"best": best, "sweep_s": sweep_s, "trials": [
        {k: v for k, v in t.items() if k != "launches"} for t in trials]}


# Phase 14: the attention and text variants through the two presets that
# run them, SAN (bi-LSTM, stacked attention) and transformer_co (the
# transformer question encoder, co-attention), at the presets' widths.
VARIANT_PRESETS = ("config_san", "config_transformer_co")
VARIANT_STEPS = 4  # train steps a preset takes at batch 512
VARIANT_DIR = "_smoke_variants"  # under the checkout; .gitignore lists it


def variant_config(preset: str):
    """The model of ``dl_vqa_tpu/config/<preset>.yaml`` at the reference's
    vocabulary, built from the port's preset dicts (no PyYAML)."""
    from dl_vqa_tpu_torch.config.presets import preset as preset_dict
    from dl_vqa_tpu_torch.models.configs import ModelConfig

    return ModelConfig.from_cfg(preset_dict(preset)["train"],
                                ModelConfig().num_tokens)


def variant_grids(cfg, recurrence: int, tokens: int, forwards: int = 1,
                  train_steps: int = 0) -> dict:
    """The grids ``forwards`` forwards without a gradient and
    ``train_steps`` train steps launch for the model of ``cfg`` (the CNN
    image encoder): the pooled bi-LSTM on kernel 1 (kernel A and B's T
    grids in a train step), the token states of (lstm, co) in f32
    (``tokens`` grids a call, a forward's or a train step's; kernel B's T
    in a train step), none with the transformer; kernel 3 a glimpse in
    stacked attention, once in single and co; kernels 2 and C a CNN
    block."""
    variant = cfg.attention.variant
    pools = cfg.attention.glimpses if variant == "stacked" else 1
    blocks = len(cfg.image.num_channels) - 1
    calls = forwards + train_steps
    grids = {"relu_maxpool": blocks * calls,
             "relu_maxpool_backward": 2 * blocks * train_steps,
             "attention_pool": pools * calls}
    if cfg.text.encoder == "lstm":
        if variant == "co":
            grids["lstm_token_states"] = tokens * calls
        else:
            grids["lstm_recurrence"] = recurrence * forwards
            grids["lstm_recurrence_save"] = recurrence * train_steps
        grids["lstm_backward_step"] = SEQ_LEN * train_steps
    return {k: v for k, v in grids.items() if v}


def lstm_co_timing(torch, seed: int, cfg, parent_lstm: str = None) -> dict:
    """(lstm, co) at batch 512 in bf16 (its token states in f32): the
    forward and a train step (dropout 0.3, Adam) timed on this tree's
    kernels and, given ``parent_lstm`` (a directory holding another
    version's ``lstm_recurrence.cu`` and ``lstm_backward.cu``), on that
    version's LSTM kernels beside this tree's others, in turns in the same
    call (``tools/compare_lstm.py``'s loader)."""
    import contextlib
    import tempfile

    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.ops import _native
    from dl_vqa_tpu_torch.tools import compare_lstm
    from dl_vqa_tpu_torch.train import create_train_state, make_train_step

    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, INITIAL_LR)
    train_step = make_train_step(cfg)
    batch = make_batch(torch, cfg, BATCH, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    imgs, qs = batch["images"], batch["questions"]
    lens = batch["lengths"]

    def forward():
        with torch.inference_mode():
            return model(imgs, qs, lens, compute_dtype=torch.bfloat16)

    versions = {"tree": contextlib.nullcontext}
    with tempfile.TemporaryDirectory() as out_dir:
        if parent_lstm:
            lib = compare_lstm.load({"parent": parent_lstm},
                                    out_dir)["parent"]
            mixed = compare_lstm.WithLstmOf(lib, _native.library())
            versions["parent"] = lambda: compare_lstm.using(mixed)

        def run(version, fn):
            def call():
                with versions[version]():
                    fn()
            return call

        out = {}
        for what, fn in (("forward", forward),
                         ("train_step",
                          lambda: train_step(state, batch, gen))):
            calls = [run(v, fn) for v in versions]
            ms = timed_turns(torch, calls, iters=3)
            out.update({f"{what}_ms" + ("" if v == "tree" else f"_{v}"): m
                        for v, m in zip(versions, ms)})
    log("variants lstm_co B=512 bf16 (token states f32): " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()))
    return out


def variants_phase(torch, seed: int, recurrence: int,
                   profile: bool = False, parent_lstm: str = None) -> tuple:
    """Phase 14 before cnn_e2e: each variant preset at full width served
    (:func:`slice_phase`: 8 requests, the logits held to the plain path,
    the batch-512 forward timed), trained (:func:`train_phase`:
    VARIANT_STEPS steps at batch 512, the gradients held to the plain
    path's at batch 8, the step timed) and exported at B = 8 (the program's
    logits the live Predictor's to the bit, its launches counted); then the
    (lstm, co) combination, which no preset has, at batch 8: served, its
    logits held to the plain path, and a train step's gradients held to the
    plain path's, the token states' f32 launches counted; then its forward
    and train step timed at batch 512 (:func:`lstm_co_timing`, with
    ``parent_lstm`` also on another version's LSTM kernels). ``profile``
    adds the presets' device time by kernel over two train and eval steps.
    Returns ``({path: launches}, numbers)``."""
    import dataclasses
    import os
    import shutil

    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.predict import Predictor
    from dl_vqa_tpu_torch.utils.aot_export import load_artifact

    wrappers = kernel_wrappers()
    tokens = f32_grids(torch)
    root = os.path.abspath(VARIANT_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    phase_start = time.perf_counter()
    paths, numbers = {}, {}
    for preset in VARIANT_PRESETS:
        cfg = variant_config(preset)
        name = preset[len("config_"):]
        entry = numbers[name] = {
            "text": cfg.text.encoder, "attention": cfg.attention.variant,
            "answers": cfg.max_answers}
        t0 = time.perf_counter()
        paths[f"{name}_serving"] = slice_phase(
            torch, seed, cfg, name, variant_grids(cfg, recurrence, tokens),
            numbers=entry)
        paths[f"{name}_training"] = train_phase(
            torch, seed, profile, cfg, name,
            variant_grids(cfg, recurrence, tokens, forwards=1,
                          train_steps=VARIANT_STEPS),
            accumulate=False, steps=VARIANT_STEPS, numbers=entry)

        # The exported program at B = 8 against the live Predictor.
        model = VqaNet(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(seed))
        live = Predictor(cfg, model, make_vocab(cfg.num_tokens,
                                                cfg.max_answers),
                         device="cuda", max_question_length=SEQ_LEN,
                         compute_dtype=torch.bfloat16)
        path = os.path.join(root, name)
        seconds = live.export_artifact(path, batch_sizes=(AOT_VARIANT_BATCH,))
        exported = load_artifact(path)
        request = aot_requests(cfg, seed)[AOT_VARIANT_BATCH]
        request = (*request[:2], np.maximum(request[2], 1))
        want = live.forward_logits(*request)
        reset_launches(wrappers)
        got = exported.logits(*request)
        torch.cuda.synchronize()
        launches = read_launches(wrappers, f"the exported {name}")
        expected = variant_grids(cfg, recurrence, tokens)
        require(launches == {**dict.fromkeys(wrappers, 0), **expected},
                f"the exported {name}: launches {launches}, expected "
                f"{expected}")
        entry["aot_max_abs_err"] = hold_bits(got, want,
                                             f"the exported {name}")
        entry["aot_export_s"] = seconds[AOT_VARIANT_BATCH]
        paths[f"aot_{name}"] = launches
        entry["phase_s"] = time.perf_counter() - t0
        log(f"variants {name}: exported at B = {AOT_VARIANT_BATCH} in "
            f"{entry['aot_export_s']:.2f} s, logits max |diff| "
            f"{entry['aot_max_abs_err']:g}, kernel launches "
            f"{json.dumps(launches)} | {entry['phase_s']:.1f} s")
        del model, live, exported

    # (lstm, co) at the reference width: the token states on kernel A's
    # f32 mode, serving and training, at batch 8.
    t0 = time.perf_counter()
    base = ModelConfig()
    cfg = dataclasses.replace(base, attention=dataclasses.replace(
        base.attention, variant="co"))
    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    predictor = Predictor(cfg, model, make_vocab(cfg.num_tokens,
                                                 cfg.max_answers),
                          device="cuda", max_question_length=SEQ_LEN,
                          compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (len(QUESTIONS), cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    reset_launches(wrappers)
    answers = predictor.predict(images, QUESTIONS, top_k=3)
    launches = read_launches(wrappers, "the (lstm, co) serving path")
    expected = variant_grids(cfg, recurrence, tokens)
    require(len(answers) == len(QUESTIONS), "one answer list per request")
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches on the (lstm, co) serving path: {launches}, "
            f"expected {expected}")
    paths["lstm_co_serving"] = launches
    encoded, lengths = predictor.encode_questions(QUESTIONS)
    entry = numbers["lstm_co"] = {"logits_max_abs_err": {}}
    for dtype, tol in ((torch.bfloat16, TOL["logits_bf16"]),
                       (torch.float32, TOL["logits_f32"])):
        predictor.compute_dtype = dtype
        kernel = predictor.forward_logits(images, encoded, lengths)
        plain = predictor.forward_logits(images, encoded, lengths,
                                         plain_ops=True)
        err = float(np.abs(kernel - plain).max())
        require(bool(np.isfinite(kernel).all()), "finite logits")
        require(err <= tol, f"(lstm, co) kernel vs plain logits {dtype}: "
                f"{err}")
        entry["logits_max_abs_err"][str(dtype)[6:]] = err
    log(f"variants lstm_co: {len(answers)} requests answered, kernel "
        f"launches {json.dumps(launches)}, logits max |kernel - plain| "
        f"{json.dumps(entry['logits_max_abs_err'])} (tol "
        f"{TOL['logits_bf16']:g} bf16, {TOL['logits_f32']:g} f32)")
    del model, predictor

    from dl_vqa_tpu_torch.train import create_train_state

    def new_state(model_cfg):
        return create_train_state(
            VqaNet(model_cfg, generator=torch.Generator().manual_seed(seed)),
            INITIAL_LR)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    reset_launches(wrappers)
    # Two dtypes, each a train step and an eval step on both paths.
    hold_to_plain_path(torch, seed, cfg, "lstm_co", gen, new_state)
    launches = read_launches(wrappers, "the (lstm, co) batch-8 steps")
    expected = variant_grids(cfg, recurrence, tokens, forwards=2,
                             train_steps=2)
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"kernel launches of the (lstm, co) steps: {launches}, expected "
            f"{expected}")
    paths["lstm_co_training"] = launches
    entry.update(lstm_co_timing(torch, seed, cfg, parent_lstm))
    entry["phase_s"] = time.perf_counter() - t0
    numbers["phase_s"] = time.perf_counter() - phase_start
    log(f"variants lstm_co: train and eval steps at B=8 held to the plain "
        f"path, kernel launches {json.dumps(launches)} | "
        f"{entry['phase_s']:.1f} s")
    return paths, numbers


MOE_PRESET = "config_vit_moe"
MOE_STEPS = 4  # train steps the ViT-MoE takes at batch 512


def moe_phase(torch, seed: int, recurrence: int, profile: bool = False
              ) -> tuple:
    """Phase 15, beside phase 14: ``config_vit_moe`` (the ViT of
    ``config_vit`` with every block's MLP a mixture of 8 experts of width
    1,024, top-2, capacity factor 1.25; built from the port's preset dicts)
    at full width, served (:func:`slice_phase`: 8 requests, the logits
    held to the plain path with the share of flipped routes, the batch-512
    forward timed), served again with ``fused_ops`` (its blocks stay on the
    MoE path: kernel 8 launches no grid, the logits are the unfused path's
    bits), trained (:func:`train_phase`: MOE_STEPS steps at batch 512, the
    gradients held to the plain path's at batch 8, the step timed, its
    ``moe_aux`` printed) and exported at B = 8 (the program's logits the
    live Predictor's to the bit, its launches counted). Returns ``({path:
    launches}, numbers)``."""
    import os
    import shutil

    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.predict import Predictor
    from dl_vqa_tpu_torch.utils.aot_export import load_artifact

    wrappers = kernel_wrappers()
    cfg = variant_config(MOE_PRESET)
    layers = cfg.image.num_layers
    require(cfg.image.moe_experts == 8 and cfg.image.moe_top_k == 2,
            "config_vit_moe routes 8 experts, top-2")
    numbers = {"experts": cfg.image.moe_experts, "top_k": cfg.image.moe_top_k,
               "capacity_factor": cfg.image.moe_capacity_factor}
    phase_start = time.perf_counter()
    serving = {"lstm_recurrence": recurrence, "attention_pool": 1,
               "vit_attention": layers}
    paths = {"vit_moe_serving": slice_phase(torch, seed, cfg, "vit_moe",
                                            serving, numbers=numbers)}

    # fused_ops: the blocks keep their experts, so the same grids and the
    # same bits as without the flip.
    model = VqaNet(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(seed))
    vocab = make_vocab(cfg.num_tokens, cfg.max_answers)
    live = Predictor(cfg, model, vocab, device="cuda",
                     max_question_length=SEQ_LEN,
                     compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (len(QUESTIONS), cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    encoded, lengths = live.encode_questions(QUESTIONS)
    unfused = live.forward_logits(images, encoded, lengths)
    live.fused_ops = True
    reset_launches(wrappers)
    fused = live.forward_logits(images, encoded, lengths)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, "the vit_moe fused_ops serving path")
    require(launches == {**dict.fromkeys(wrappers, 0), **serving},
            f"the vit_moe fused_ops path: launches {launches}, expected "
            f"{serving}")
    require(np.array_equal(fused, unfused),
            "fused_ops leaves the MoE blocks as they are")
    paths["vit_moe_fused_serving"] = launches
    live.fused_ops = False
    log(f"vit_moe fused_ops: kernel launches {json.dumps(launches)}, logits "
        "equal to the unfused path's bits")

    paths["vit_moe_training"] = train_phase(
        torch, seed, profile, cfg, "vit_moe",
        {"lstm_recurrence": recurrence,
         "lstm_recurrence_save": MOE_STEPS * recurrence,
         "lstm_backward_step": MOE_STEPS * SEQ_LEN,
         "attention_pool": MOE_STEPS + 1,
         "vit_attention": layers * (MOE_STEPS + 1),
         "vit_attention_backward": layers * MOE_STEPS},
        accumulate=False, steps=MOE_STEPS, numbers=numbers)

    # The exported program at B = 8 against the live Predictor.
    root = os.path.abspath(VARIANT_DIR)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "vit_moe")
    shutil.rmtree(path, ignore_errors=True)
    seconds = live.export_artifact(path, batch_sizes=(AOT_VARIANT_BATCH,))
    exported = load_artifact(path)
    request = aot_requests(cfg, seed)[AOT_VARIANT_BATCH]
    request = (*request[:2], np.maximum(request[2], 1))
    want = live.forward_logits(*request)
    reset_launches(wrappers)
    got = exported.logits(*request)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, "the exported vit_moe")
    require(launches == {**dict.fromkeys(wrappers, 0), **serving},
            f"the exported vit_moe: launches {launches}, expected {serving}")
    numbers["aot_max_abs_err"] = hold_bits(got, want, "the exported vit_moe")
    numbers["aot_export_s"] = seconds[AOT_VARIANT_BATCH]
    paths["aot_vit_moe"] = launches
    numbers["phase_s"] = time.perf_counter() - phase_start
    log(f"vit_moe: exported at B = {AOT_VARIANT_BATCH} in "
        f"{numbers['aot_export_s']:.2f} s, logits max |diff| "
        f"{numbers['aot_max_abs_err']:g}, kernel launches "
        f"{json.dumps(launches)} | phase {numbers['phase_s']:.1f} s")
    del model, live, exported
    return paths, numbers


def variants_e2e_phase(torch, seed: int, prof: dict) -> tuple:
    """Phase 14 after cnn_e2e: ``dl_vqa_tpu_torch.main.main`` trains
    ``config_transformer_co`` (the transformer question encoder,
    co-attention, 10,000 answers) for one epoch on cnn_e2e's corpus (batch
    512, bf16, dropout 0.3, the table on), and ``evaluate_vqa`` scores its
    best checkpoint with the preset's model settings: the loop's best
    score. Returns ``(launches, numbers)``."""
    import contextlib
    import os

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2
    from dl_vqa_tpu_torch.main import main as train_main

    wrappers = kernel_wrappers()
    root = os.path.abspath(E2E_DIR)
    preset = "config_transformer_co"
    extra = ["train.num_epochs=1", "tpu.checkpoint_every_steps=0"]
    from dl_vqa_tpu_torch.data.dataset import VQADataset

    reset_launches(wrappers)
    phase_start = t0 = time.perf_counter()
    best = train_main(config_mod.compose(preset, e2e_overrides(
        prof, root, "variants_tco", seed, extra)))
    train_s = time.perf_counter() - t0
    best_ckpt = os.path.join(exp_dir_of(root, "variants_tco"), "model.ckpt")
    cfg = variant_config(preset)
    t0 = time.perf_counter()
    stdout = os.path.join(root, "variants_evaluate_stdout.txt")
    with open(stdout, "w") as out, contextlib.redirect_stdout(out):
        score = evaluate_hw2(e2e_overrides(prof, root, "variants_eval", seed, [
            f"main.small.paths.pretrained_model_path={best_ckpt}",
            f"train.text.encoder={cfg.text.encoder}",
            f"train.attention.variant={cfg.attention.variant}",
            f"train.max_answers={cfg.max_answers}",
            "train.image.stride=1", "train.attention.do_option=+"]))
    eval_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches(wrappers, "the transformer_co journey")
    # The epoch's steps, its evaluation and evaluate_vqa's, on the CNN's
    # kernels and kernel 3; no LSTM kernel.
    train_ds, val_ds = (
        VQADataset.load(VQADataset.cache_path(prof[split]["vqaDataset"]))
        for split in ("train_paths", "val_paths"))
    steps = -(-len(train_ds) // BATCH)
    evals = 2 * -(-len(val_ds) // BATCH)
    expected = {"relu_maxpool": 3 * (steps + evals),
                "relu_maxpool_backward": 6 * steps,
                "attention_pool": steps + evals}
    require(launches == {**dict.fromkeys(wrappers, 0), **expected},
            f"the transformer_co journey: launches {launches}, expected "
            f"{expected}")
    require(abs(score - best) <= TOL["e2e_eval_score"],
            f"evaluate_vqa {score} against the loop's best {best}")
    log(f"variants transformer_co e2e: main 1 epoch in {train_s:.1f} s, best "
        f"{best:.4f}; evaluate_vqa {score:.3f} in {eval_s:.1f} s | kernel "
        f"launches {json.dumps(launches)}")
    return launches, {"best_score": best, "eval_score": score,
                      "train_s": train_s, "eval_s": eval_s,
                      "phase_s": time.perf_counter() - phase_start}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel over two "
                             "train steps and the quantized forwards")
    parser.add_argument("--parent-lstm", metavar="DIR",
                        help="also time (lstm, co) at batch 512 on the "
                             "LSTM kernels of the lstm_recurrence.cu and "
                             "lstm_backward.cu in DIR (another version's)")
    parser.add_argument("--aot-client", nargs=3,
                        metavar=("ARTIFACT", "REQUESTS", "OUT"),
                        help="the aot phase's process that serves an "
                             "artifact (started by the phase itself)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import dl_vqa_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.aot_client:
        return aot_client(*args.aot_client)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    start = time.perf_counter()
    card = device_phase(torch)
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
    # The quantized serving modes: the f8 store (kernel 2's e4m3 mode in
    # place of its compute mode, three grids), the int8 stem (kernel 2's
    # int8 mode for conv0, kernel D for conv1 and conv2), the int8 ViT (its
    # products on torch._int_mm, kernel 4 for the attention cores); one f8
    # train step (kernel C its backward).
    quant = {}
    for path, cfg, store, grids in (
            ("cnn_f8_serving", ModelConfig(), "f8e4m3",
             {"relu_maxpool_e4m3": 3}),
            ("cnn_int8_serving", ModelConfig(), "int8",
             {"relu_maxpool_int8": 1, "conv_relu_pool_int8": 2}),
            ("vit_int8_serving", vit_config(), "int8",
             {"vit_attention": vit_layers})):
        paths[path], quant[path] = quant_serving_phase(
            torch, args.seed, cfg, path.split("_")[0], store,
            {"lstm_recurrence": recurrence, "attention_pool": 1, **grids},
            args.profile)
    paths["cnn_f8_training"], quant["cnn_f8_training"] = f8_train_phase(
        torch, args.seed, ModelConfig(),
        {"lstm_recurrence_save": recurrence, "lstm_backward_step": SEQ_LEN,
         "attention_pool": 1, "relu_maxpool_e4m3": 3,
         "relu_maxpool_backward": 6})
    # The serving front on one full-width checkpoint: the decoder against
    # the fixtures, the Python front and its int8 server, then the native
    # front; the closed-loop clients run in a process of their own.
    import multiprocessing

    serving = {"card": card, "decode": decode_check(torch)}
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        served, numbers, (python_answers, ref) = serving_http_phase(
            torch, args.seed, pool, recurrence)
        paths.update(served)
        serving.update(numbers)
        native, serving["serving_native"] = serving_native_phase(
            torch, args.seed, pool, recurrence, python_answers)
    vocab = make_vocab(ModelConfig().num_tokens, ModelConfig().max_answers)
    serving["serve_cli"] = serving_cli_phase(
        fixture_requests(), ref,
        {i: a for a, i in vocab["answer"].items()})
    if native is not None:
        paths["serving_native"] = native
    # The AOT artifact of the same checkpoint, and its variants.
    aot_paths, aot = aot_phase(torch, args.seed, recurrence)
    paths.update(aot_paths)
    log(json.dumps({"aot": {"card": card, **aot}}))
    # Phase 14: the variant presets and (lstm, co); their journey after
    # cnn_e2e's corpus exists.
    variant_paths, variants = variants_phase(torch, args.seed, recurrence,
                                             args.profile, args.parent_lstm)
    paths.update(variant_paths)
    # Phase 15: the ViT-MoE.
    moe_paths, moe = moe_phase(torch, args.seed, recurrence, args.profile)
    paths.update(moe_paths)
    log(json.dumps({"vit_moe": {"card": card, **moe}}))
    paths["cnn_e2e"], e2e, e2e_profile = e2e_phase(torch, args.seed)
    log(json.dumps({"cnn_e2e": e2e}))
    # Phase 16: the image data plane from JPEG files.
    paths["online_e2e"], online = online_phase(torch, args.seed,
                                               e2e_profile, e2e)
    log(json.dumps({"online_e2e": {"card": card, **online}}))
    paths["cnn_e2e_quant_eval"], quant["cnn_e2e_quant_eval"] = (
        e2e_quant_eval_phase(torch, args.seed, e2e_profile,
                             e2e["best_score"]))
    log(json.dumps({"quant": quant}))
    paths["sweep"], sweep = sweep_phase(torch, args.seed, e2e_profile)
    log(json.dumps({"sweep": {"card": card, **sweep}}))
    paths["transformer_co_e2e"], variants["transformer_co_e2e"] = (
        variants_e2e_phase(torch, args.seed, e2e_profile))
    variants["phase_s"] += variants["transformer_co_e2e"]["phase_s"]
    log(json.dumps({"variants": {"card": card, **variants}}))
    serving["submission"] = submission_phase(torch, args.seed, e2e_profile)
    log(json.dumps({"serving": serving}))
    log(f"total {time.perf_counter() - start:.1f} s")

    csrc = "dl_vqa_tpu_torch/csrc/"
    sources = {
        "lstm_recurrence": ("lstm_recurrence.cu",
                            "dl_vqa_tpu/ops/lstm_pallas.py:139"),
        "lstm_recurrence_save": ("lstm_recurrence.cu",
                                 "dl_vqa_tpu/ops/lstm_pallas.py:177"),
        # Kernel A's f32 mode: the co-attention's per-token states, an f32
        # lax.scan in the JAX package (no TPU kernel behind it).
        "lstm_token_states": ("lstm_recurrence.cu",
                              "dl_vqa_tpu/ops/lstm.py:109"),
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
        # No TPU kernel behind these three: XLA computes them in the JAX
        # package (the f8 store and pool, the int8 store and pool, the W8A8
        # block).
        "relu_maxpool_e4m3": ("relu_maxpool.cu",
                              "dl_vqa_tpu/ops/conv_fused.py:121"),
        "relu_maxpool_int8": ("relu_maxpool.cu",
                              "dl_vqa_tpu/ops/conv_int8.py:76"),
        "conv_relu_pool_int8": ("conv_relu_pool_int8.cu",
                                "dl_vqa_tpu/ops/conv_int8.py:95"),
    }
    # The tensor-core instruction of the fused-path kernels in bf16, and of
    # kernel D at the model's shapes in int8.
    mma = {"conv_relu_pool_fused": "wgmma", "vit_mlp_fused": "wgmma",
           "conv_relu_pool_stem": "mma.sync",
           "conv_relu_pool_int8": "wgmma"}
    # launches: the grids of all paths together, each path counted from 0:
    # serving is 8 requests, training 8 train steps and an eval step, the
    # fused_ops train and eval paths one step each, the layout probe its
    # eight cases in one launch, cnn_e2e its three runs of the train loop
    # and one evaluation (e2e_phase), the serving front's paths every
    # batch their fronts served (the fixtures and the closed loop).
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
