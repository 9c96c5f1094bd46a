"""The port's kernel modules against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernel in interpret mode, and its plain XLA version) and
through the port's dispatch, which runs the plain PyTorch version for a
CPU tensor. All in f32; tolerance atol = rtol = 1e-5 (f32 sums taken in
another order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dl_vqa_tpu.ops import attention_pool as jax_attention_pool
from dl_vqa_tpu.ops import conv_fused as jax_conv
from dl_vqa_tpu.ops import lstm as jax_lstm
from dl_vqa_tpu.ops.lstm_pallas import lstm_scan_pallas
from dl_vqa_tpu_torch.ops import attention_pool as port_attention_pool
from dl_vqa_tpu_torch.ops import conv_fused as port_conv
from dl_vqa_tpu_torch.ops import lstm as port_lstm
from dl_vqa_tpu_torch.ops.lstm_cuda import lstm_recurrence_cuda

TOL = dict(atol=1e-5, rtol=1e-5)


def _lstm_params(rng, emb, hid):
    """JAX layout ([in, out]) and the port's torch layout of one direction."""
    jax_p = {
        "w_ih": (rng.standard_normal((emb, 4 * hid)) * 0.1).astype(np.float32),
        "w_hh": (rng.standard_normal((hid, 4 * hid)) * 0.1).astype(np.float32),
        "b": (rng.standard_normal(4 * hid) * 0.1).astype(np.float32),
    }
    port_p = {
        "weight_ih": torch.from_numpy(jax_p["w_ih"].T.copy()),
        "weight_hh": torch.from_numpy(jax_p["w_hh"].T.copy()),
        "bias": torch.from_numpy(jax_p["b"]),
    }
    return {k: jnp.asarray(v) for k, v in jax_p.items()}, port_p


def _lstm_inputs(seed, batch, seq, emb):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, emb)).astype(np.float32)
    lengths = rng.integers(1, seq + 1, batch).astype(np.int32)
    lengths[0], lengths[-1] = 1, seq
    return rng, x, lengths


@pytest.mark.parametrize("batch,seq,emb,hid", [(16, 11, 16, 32), (3, 5, 8, 16)])
def test_lstm_scan_matches_pallas_kernel_and_scan(batch, seq, emb, hid):
    rng, x, lengths = _lstm_inputs(1, batch, seq, emb)
    jax_p, port_p = _lstm_params(rng, emb, hid)
    h_k, c_k = lstm_scan_pallas(jnp.asarray(x), jnp.asarray(lengths), jax_p,
                                True)
    h_s, c_s = jax_lstm.lstm_scan(jnp.asarray(x), jnp.asarray(lengths), jax_p)
    h, c = port_lstm.lstm_scan(torch.from_numpy(x), torch.from_numpy(lengths),
                               port_p)
    for expected in ((h_k, c_k), (h_s, c_s)):
        np.testing.assert_allclose(h.numpy(), np.asarray(expected[0]), **TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(expected[1]), **TOL)


@pytest.mark.parametrize("batch,seq", [(6, 9), (1, 23)])
def test_bilstm_final_cell_matches_jax(batch, seq):
    emb, hid = 12, 16
    rng, x, lengths = _lstm_inputs(2, batch, seq, emb)
    jf, pf = _lstm_params(rng, emb, hid)
    jb, pb = _lstm_params(rng, emb, hid)
    expected = jax_lstm.bilstm_final_cell(jnp.asarray(x), jnp.asarray(lengths),
                                          jf, jb)
    got = port_lstm.bilstm_final_cell(torch.from_numpy(x),
                                      torch.from_numpy(lengths), pf, pb)
    assert got.shape == (batch, 2 * hid) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_bilstm_backward_direction_is_the_pallas_kernel_on_reversed_prefix():
    batch, seq, emb, hid = 8, 7, 8, 16
    rng, x, lengths = _lstm_inputs(3, batch, seq, emb)
    jf, pf = _lstm_params(rng, emb, hid)
    jb, pb = _lstm_params(rng, emb, hid)
    x_rev = jax_lstm.reverse_valid_prefix(jnp.asarray(x), jnp.asarray(lengths))
    _, c_fwd = lstm_scan_pallas(jnp.asarray(x), jnp.asarray(lengths), jf, True)
    _, c_bwd = lstm_scan_pallas(x_rev, jnp.asarray(lengths), jb, True)
    got = port_lstm.bilstm_final_cell(torch.from_numpy(x),
                                      torch.from_numpy(lengths), pf, pb)
    np.testing.assert_allclose(
        got.numpy(), np.concatenate([c_fwd, c_bwd], axis=-1), **TOL)


@pytest.mark.parametrize("seq,lengths", [(6, [1, 6, 3, 4]), (3, [3, 2])])
def test_reverse_valid_prefix_matches_jax(seq, lengths):
    rng = np.random.default_rng(4)
    lengths = np.array(lengths, dtype=np.int32)
    x = rng.standard_normal((len(lengths), seq, 5)).astype(np.float32)
    got = port_lstm.reverse_valid_prefix(torch.from_numpy(x),
                                         torch.from_numpy(lengths))
    expected = jax_lstm.reverse_valid_prefix(jnp.asarray(x),
                                             jnp.asarray(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(got[b, :n].numpy(), x[b, :n][::-1])


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(5)
    batch, hid = 4, 8
    x_proj = rng.standard_normal((batch, 4 * hid)).astype(np.float32)
    h = rng.standard_normal((batch, hid)).astype(np.float32)
    c = rng.standard_normal((batch, hid)).astype(np.float32)
    w_hh = (rng.standard_normal((hid, 4 * hid)) * 0.3).astype(np.float32)
    eh, ec = jax_lstm.lstm_cell(*(jnp.asarray(a) for a in (x_proj, h, c, w_hh)))
    gh, gc = port_lstm.lstm_cell(torch.from_numpy(x_proj), torch.from_numpy(h),
                                 torch.from_numpy(c),
                                 torch.from_numpy(w_hh.T.copy()))
    np.testing.assert_allclose(gh.numpy(), np.asarray(eh), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(ec), **TOL)


@pytest.mark.parametrize("shape", [(2, 30, 30, 16), (3, 21, 23, 8),
                                   (1, 9, 10, 64)])
def test_relu_maxpool_matches_pallas_kernel(shape):
    """Odd sizes drop the last row/column (floor pooling)."""
    rng = np.random.default_rng(6)
    y = rng.standard_normal(shape).astype(np.float32)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    expected = jax_conv.relu_maxpool_pallas_direct(jnp.asarray(y),
                                                   jnp.asarray(b),
                                                   interpret=True)
    got = port_conv.relu_maxpool(torch.from_numpy(y), torch.from_numpy(b))
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("h,w,cin,cout,k,stride", [
    (16, 16, 3, 8, 3, 1),
    (17, 20, 8, 12, 3, 1),   # odd conv output: floor pooling
    (21, 21, 4, 6, 3, 2),
    (14, 15, 5, 7, 5, 1),
])
def test_conv_relu_pool_matches_jax_reference(h, w, cin, cout, k, stride):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    w_hwio = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    expected = np.asarray(jax_conv.conv_relu_pool_reference(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b), stride))
    args = (torch.from_numpy(x),
            torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(b), stride)
    for fn in (port_conv.conv_relu_pool, port_conv.conv_relu_pool_reference):
        got = fn(*args)
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("batch,grid,channels,glimpses", [
    (16, 6, 32, 2), (8, 5, 24, 1), (8, 4, 16, 3)])
def test_attention_pool_matches_pallas_kernel(batch, grid, channels, glimpses):
    rng = np.random.default_rng(8)
    v = rng.standard_normal((batch, grid, grid, channels)).astype(np.float32)
    att = rng.standard_normal((batch, grid, grid, glimpses)).astype(np.float32)
    expected = jax_attention_pool.attention_pool_pallas(
        jnp.asarray(v), jnp.asarray(att), interpret=True)
    reference = jax_attention_pool.attention_pool_reference(
        jnp.asarray(v), jnp.asarray(att))
    got = port_attention_pool.attention_pool(torch.from_numpy(v),
                                             torch.from_numpy(att))
    assert got.shape == (batch, glimpses * channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(reference), **TOL)


@pytest.mark.parametrize("call", [
    lambda: port_conv.relu_maxpool_cuda(torch.zeros(1, 4, 4, 2),
                                        torch.zeros(2)),
    lambda: port_attention_pool.attention_pool_cuda(
        torch.zeros(1, 2, 2, 3), torch.zeros(1, 2, 2, 2)),
    lambda: lstm_recurrence_cuda(torch.zeros(1, 2, 3, 64),
                                 torch.zeros(1, 64, 16),
                                 torch.ones(3, dtype=torch.int32)),
], ids=["relu_maxpool", "attention_pool", "lstm_recurrence"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises; it never falls back to the
    plain version, and it checks its inputs before building anything."""
    with pytest.raises(ValueError, match="CUDA"):
        call()
