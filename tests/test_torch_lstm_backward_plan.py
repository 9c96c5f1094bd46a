"""Kernel B's dispatch rule and work split, the LSTM backward's loop, and
kernel 9's batched plan, on the CPU.

Kernel B (``csrc/lstm_backward.cu``) runs a vector kernel where
``ops/lstm_cuda.py::backward_step_vector_path`` says so; the mirror of its
work split writes every ``dgates`` element of a step exactly once, reads
and writes ``dh`` and ``dc`` once on a real row and never on a padded one.
The rule's constants are read from the CUDA source. The loop around it
(``ops/lstm.py::lstm_saved_state_backward``, plain version, ``dW_hh`` from
views of the saved carries) is held to the JAX package's
``_lstm_saved_state_bwd`` on the same seeded numpy inputs: f32, atol = rtol
= 1e-5 (f32 sums in another order). Kernel 9's batched entry
(``csrc/layout_cases.cu::vqa_layout_cases``) lays its grid over (case,
output vector); its mirror covers every output vector of every case once.
The card tests hold the C entries to the mirrors.
"""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dl_vqa_tpu.ops.lstm_pallas import _lstm_saved_state_bwd
from dl_vqa_tpu_torch.ops import layout_cases as port_layout
from dl_vqa_tpu_torch.ops import lstm as port_lstm
from dl_vqa_tpu_torch.ops import lstm_cuda
from dl_vqa_tpu_torch.ops.lstm_cuda import (
    BACKWARD_MAX_VECTOR_THREADS,
    BACKWARD_THREADS,
    BACKWARD_VECTOR_FLOATS,
    backward_step_vector_accesses,
    backward_step_vector_path,
)

CSRC = os.path.join(os.path.dirname(lstm_cuda.__file__), os.pardir, "csrc")
TOL = dict(atol=1e-5, rtol=1e-5)


def _source(name):
    with open(os.path.join(CSRC, name)) as fd:
        return fd.read()


def _constant(source, name):
    found = re.search(rf"constexpr \w+ {name} = ([^;]+);", source)
    assert found, name
    return found.group(1).strip()


# ----------------------------------------------------------------- kernel B

def test_backward_step_mirror_matches_the_source():
    source = _source("lstm_backward.cu")
    assert int(_constant(source, "kThreads")) == BACKWARD_THREADS
    assert int(_constant(source, "kVectorFloats")) == BACKWARD_VECTOR_FLOATS
    assert _constant(source, "kMaxVectorThreads") == "int64_t{1} << 31"
    assert BACKWARD_MAX_VECTOR_THREADS == 1 << 31
    rule = source[source.index("bool vector_path("):]
    rule = rule[:rule.index("}")]
    for clause in ("hidden % kVectorFloats == 0",
                   "threads < kMaxVectorThreads", "aligned(gates_all)",
                   "aligned(c_all)", "aligned(dh)", "aligned(dc)",
                   "aligned(dgates_all)"):
        assert clause in rule, clause


@pytest.mark.parametrize("directions,batch,hidden,vector", [
    (2, 512, 1024, True),   # the text encoder of both models, B = 512
    (2, 8, 1024, True),     # the gradient checks' batch
    (1, 512, 1024, True),   # lstm_scan, one direction
    (2, 5, 32, True), (1, 1, 4, True),
    (2, 5, 6, False), (1, 3, 1, False), (2, 7, 1022, False),
    (2, 2 ** 20, 4096, False),  # 2^31 threads: over the 31-bit index
])
def test_backward_step_vector_path(directions, batch, hidden, vector):
    assert backward_step_vector_path(directions, batch, hidden) is vector


def test_backward_step_vector_path_needs_16_byte_boundaries():
    assert backward_step_vector_path(2, 8, 1024, (0, 16, 32, 4096, 256))
    for off in (4, 8, 12):
        for k in range(5):
            pointers = [256] * 5
            pointers[k] += off
            assert not backward_step_vector_path(2, 8, 1024, pointers)


def _touched(work):
    counts = {}
    for thread in work:
        for tensor, kind, first in thread:
            for e in range(first, first + BACKWARD_VECTOR_FLOATS):
                counts.setdefault((tensor, kind), Counter())[e] += 1
    return counts


@pytest.mark.parametrize("directions,seq,batch,hidden", [
    (2, 5, 3, 8), (1, 4, 70, 4), (2, 3, 2, 1024)])
def test_backward_step_work_split(directions, seq, batch, hidden):
    """Every dgates element of step t written once and no other step's;
    a real row reads its gates, c_t, c_prev (t > 0), dh and dc once and
    writes dh and dc once; a padded row touches none of them."""
    lengths = [0, seq] + [1 + b % seq for b in range(batch - 2)]
    four_h = 4 * hidden
    for t in range(seq):
        counts = _touched(backward_step_vector_accesses(
            directions, seq, batch, hidden, t, lengths))
        assert set(counts) <= {
            ("gates_all", "read"), ("c_all", "read"), ("dh", "read"),
            ("dc", "read"), ("dgates_all", "write"), ("dh", "write"),
            ("dc", "write")}
        written = counts[("dgates_all", "write")]
        assert set(written.values()) == {1}
        assert sorted(written) == [
            ((d * seq + t) * batch + b) * four_h + e
            for d in range(directions) for b in range(batch)
            for e in range(four_h)]
        real = [(d, b) for d in range(directions) for b in range(batch)
                if t < lengths[b]]
        carry = sorted((d * batch + b) * hidden + j for d, b in real
                       for j in range(hidden))
        for key in (("dh", "read"), ("dc", "read"), ("dh", "write"),
                    ("dc", "write")):
            got = counts.get(key, Counter())
            assert sorted(got) == carry and set(got.values()) <= {1}, key
        gates = counts.get(("gates_all", "read"), Counter())
        assert sorted(gates) == sorted(
            ((d * seq + t) * batch + b) * four_h + e for d, b in real
            for e in range(four_h))
        c_read = counts.get(("c_all", "read"), Counter())
        want = Counter()
        for d, b in real:
            for s in ([t, t - 1] if t else [t]):
                for j in range(hidden):
                    want[((d * seq + s) * batch + b) * hidden + j] += 1
        assert c_read == want


def test_backward_step_grid_is_whole_blocks():
    """The threads past D * B * H / 4 in the last block make nothing."""
    work = backward_step_vector_accesses(2, 3, 5, 8, 1, [3, 0, 1, 2, 3])
    assert len(work) == BACKWARD_THREADS
    assert all(thread for thread in work[:2 * 5 * 2])
    assert not any(work[2 * 5 * 2:])


# ------------------------------------------------------- the backward's loop

def _backward_case(seed, directions, seq, batch, hidden, emb, lengths):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "gates": normal(directions, seq, batch, 4 * hidden),
        "c": normal(directions, seq, batch, hidden, scale=0.5),
        "h": normal(directions, seq, batch, hidden, scale=0.5),
        "w_hh": normal(directions, hidden, 4 * hidden, scale=0.2),
        "w_ih": normal(directions, emb, 4 * hidden, scale=0.2),
        "x": normal(directions, batch, seq, emb),
        "dh": normal(directions, batch, hidden),
        "dc": normal(directions, batch, hidden),
        "lengths": np.asarray(lengths, dtype=np.int32),
    }


@pytest.mark.parametrize("seq,lengths", [(1, [0, 1, 1]), (5, [0, 5, 2])])
def test_saved_state_backward_matches_jax(seq, lengths):
    """D = 2 directions, each held to ``_lstm_saved_state_bwd`` on its own:
    dW_hh (from the views, no step-0 term), db (the sum of dgates) and dx
    (dgates . W_ih); T = 1 gives a zero dW_hh."""
    directions, batch, hidden, emb = 2, 3, 8, 4
    case = _backward_case(21 + seq, directions, seq, batch, hidden, emb,
                          lengths)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    dgates, dw_hh = port_lstm.lstm_saved_state_backward(
        t["gates"], t["c"], t["h"], t["w_hh"].transpose(1, 2).contiguous(),
        t["lengths"], t["dh"], t["dc"], plain=True)
    assert dgates.shape == (directions, seq, batch, 4 * hidden)
    assert dw_hh.shape == (directions, 4 * hidden, hidden)
    if seq == 1:
        assert torch.count_nonzero(dw_hh) == 0
    for d in range(directions):
        params = {"w_ih": jnp.asarray(case["w_ih"][d]),
                  "w_hh": jnp.asarray(case["w_hh"][d]),
                  "b": jnp.zeros(4 * hidden, jnp.float32)}
        saved = tuple(jnp.asarray(case[k][d]) for k in ("gates", "c", "h"))
        dx, _, dparams = _lstm_saved_state_bwd(
            jnp.asarray(case["x"][d]), jnp.asarray(case["lengths"]), params,
            saved, (jnp.asarray(case["dh"][d]), jnp.asarray(case["dc"][d])))
        np.testing.assert_allclose(dw_hh[d].t().numpy(),
                                   np.asarray(dparams["w_hh"]), **TOL)
        np.testing.assert_allclose(dgates[d].sum(dim=(0, 1)).numpy(),
                                   np.asarray(dparams["b"]), **TOL)
        port_dx = torch.einsum("tbg,eg->bte", dgates[d], t["w_ih"][d])
        np.testing.assert_allclose(port_dx.numpy(), np.asarray(dx), **TOL)
    # A padded step hands nothing on: its dgates rows are zero.
    for b, n in enumerate(lengths):
        assert torch.all(dgates[:, n:, b] == 0)


# ------------------------------------------------------------------ kernel 9

def test_layout_mirror_matches_the_source():
    source = _source("layout_cases.cu")
    assert int(_constant(source, "kThreads")) == port_layout.THREADS
    assert int(_constant(source, "kMaxCases")) == port_layout.MAX_CASES


PROBE_CASES = [((16, 32, c), m, torch.bfloat16)
               for c in (64, 128) for m in port_layout.MODES]
ODD_CASES = [((3, 6, 4), "split", torch.float32),
             ((0, 4, 8), "shift", torch.bfloat16),   # no output: no block
             ((5, 7, 8), "shift", torch.bfloat16),
             ((2, 2, 4), "merge", torch.float32),
             ((1, 2, 8), "strided", torch.bfloat16)]


@pytest.mark.parametrize("cases", [PROBE_CASES, ODD_CASES,
                                   PROBE_CASES[3:4]],
                         ids=["probe", "odd", "one"])
def test_batched_plan_covers_every_output_vector_once(cases):
    shapes, modes, dtypes = zip(*cases)
    plan = port_layout.batched_plan(shapes, modes, dtypes)
    first = 0
    for (shape, mode, dtype), entry in zip(cases, plan):
        out = port_layout.output_shape(shape, mode)
        assert entry["vectors"] * 16 == (out[0] * out[1] * out[2]
                                         * dtype.itemsize)
        assert entry["first_block"] == first
        assert entry["blocks"] == -(-entry["vectors"] // port_layout.THREADS)
        first += entry["blocks"]
    made = Counter()
    for block in range(first):
        made.update(v for v in port_layout.batched_vectors(plan, block) if v)
    assert set(made.values()) <= {1}
    assert sorted(made) == [(k, e) for k, entry in enumerate(plan)
                            for e in range(entry["vectors"])]


def test_probe_plan_is_one_small_grid():
    """The probe's eight cases: 8 to 32 blocks each (a block makes 256
    vectors of 16 bytes, 4 KB), 144 in all."""
    shapes, modes, dtypes = zip(*PROBE_CASES)
    plan = port_layout.batched_plan(shapes, modes, dtypes)
    assert [p["blocks"] for p in plan] == [8, 16, 8, 16, 16, 32, 16, 32]
    assert [p["first_block"] for p in plan] == [0, 8, 24, 32, 48, 64, 96,
                                                112]


def test_batched_dispatch_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          .to(dtype) for shape, _, dtype in PROBE_CASES]
    modes = [m for _, m, _ in PROBE_CASES]
    got = port_layout.layout_cases(xs, modes)
    for x, mode, out in zip(xs, modes, got):
        assert torch.equal(out, port_layout.layout_case_reference(x, mode))


@pytest.mark.parametrize("call", [
    lambda: port_layout.layout_cases_cuda([torch.zeros(2, 4, 8)], ["split"]),
    lambda: port_layout.layout_cases_cuda(
        [torch.zeros(2, 4, 8)] * 9, ["split"] * 9),
    lambda: port_layout.layout_cases_cuda([torch.zeros(2, 4, 8)], []),
], ids=["cpu", "nine_cases", "no_mode"])
def test_batched_wrapper_raises_on_what_it_does_not_take(call):
    with pytest.raises(ValueError):
        call()
