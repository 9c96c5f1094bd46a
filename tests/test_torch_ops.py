"""The port's kernel modules against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(its Pallas kernel in interpret mode, and its plain XLA version) and
through the port's dispatch, which runs the plain PyTorch version for a
CPU tensor: forward values, the states saved for the backward, and
gradients against ``jax.grad``. In f32 unless a test says otherwise;
tolerance atol = rtol = 1e-5 (f32 sums taken in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_vqa_tpu.ops import attention_pool as jax_attention_pool
from dl_vqa_tpu.ops import conv_fused as jax_conv
from dl_vqa_tpu.ops import lstm as jax_lstm
from dl_vqa_tpu.ops.lstm_pallas import (
    _lstm_scan_pallas_impl,
    lstm_scan_pallas,
)
from dl_vqa_tpu_torch.ops import attention_pool as port_attention_pool
from dl_vqa_tpu_torch.ops import conv_fused as port_conv
from dl_vqa_tpu_torch.ops import lstm as port_lstm
from dl_vqa_tpu_torch.ops.lstm_cuda import (
    lstm_backward_step_cuda,
    lstm_recurrence_cuda,
    lstm_recurrence_save_cuda,
)

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


# ------------------------------------------------------------- gradients

def _lstm_grad_case(seed, batch, seq, emb, hid, lengths=None):
    rng, x, random_lengths = _lstm_inputs(seed, batch, seq, emb)
    lengths = (random_lengths if lengths is None
               else np.asarray(lengths, dtype=np.int32))
    jax_p, port_p = _lstm_params(rng, emb, hid)
    # Cotangents of both outputs: dh_final is nonzero too.
    gh = rng.standard_normal((batch, hid)).astype(np.float32)
    gc = rng.standard_normal((batch, hid)).astype(np.float32)
    return x, lengths, jax_p, port_p, gh, gc


def _jax_lstm_grads(scan, x, lengths, jax_p, gh, gc):
    def loss(x_, p_):
        h, c = scan(x_, jnp.asarray(lengths), p_)
        return jnp.sum(h * gh) + jnp.sum(c * gc)

    return jax.grad(loss, argnums=(0, 1))(x, jax_p)


def _port_lstm_grads(x, lengths, port_p, gh, gc, dtype=torch.float32):
    x_t = torch.from_numpy(x).to(dtype).requires_grad_()
    params = {k: v.clone().requires_grad_() for k, v in port_p.items()}
    h, c = port_lstm.lstm_scan(x_t, torch.from_numpy(lengths), params)
    (torch.sum(h * torch.from_numpy(gh))
     + torch.sum(c * torch.from_numpy(gc))).backward()
    return x_t.grad, {"w_ih": params["weight_ih"].grad.t(),
                      "w_hh": params["weight_hh"].grad.t(),
                      "b": params["bias"].grad}


@pytest.mark.parametrize("batch,seq,emb,hid,lengths", [
    (16, 9, 12, 16, None),                    # ragged, includes 1 and T
    (8, 5, 8, 16, [1] * 8),                   # every length 1
    (8, 5, 8, 16, [5] * 8),                   # every length T
    (3, 6, 8, 32, [6, 1, 3]),
])
def test_lstm_gradients_match_jax_pallas_path_and_scan(batch, seq, emb, hid,
                                                       lengths):
    """The Function's plain save forward and plain backward against
    ``jax.grad`` of the Pallas path (interpret mode: the saved-state
    backward the port copies) and of ``lstm_scan`` (XLA autodiff)."""
    x, lengths, jax_p, port_p, gh, gc = _lstm_grad_case(11, batch, seq, emb,
                                                        hid, lengths)
    dx, dparams = _port_lstm_grads(x, lengths, port_p, gh, gc)
    for scan in (lambda *a: lstm_scan_pallas(*a, True), jax_lstm.lstm_scan):
        ex, eparams = _jax_lstm_grads(scan, jnp.asarray(x), lengths, jax_p,
                                      gh, gc)
        np.testing.assert_allclose(dx.numpy(), np.asarray(ex), **TOL)
        for name, expected in eparams.items():
            np.testing.assert_allclose(dparams[name].numpy(),
                                       np.asarray(expected), err_msg=name,
                                       **TOL)
    # A padded step hands nothing to the inputs.
    for b, n in enumerate(lengths):
        assert torch.all(dx[b, n:] == 0)


def test_lstm_bf16_gradients_match_jax_pallas_path():
    """bf16 compute: x_proj, h and W_hh are rounded in the forward, the
    backward runs in f32 on the f32 master weights, as in the JAX package.
    Weight gradients differ by the order of f32 sums only (atol 1e-4 on
    values of order 1 to 10, summed over 144 rows); dx is rounded to
    bf16 at the end, so one bf16 step (2^-8 relative) is allowed."""
    x, lengths, jax_p, port_p, gh, gc = _lstm_grad_case(12, 16, 9, 12, 16)
    x_bf16 = jnp.asarray(x).astype(jnp.bfloat16)
    ex, eparams = _jax_lstm_grads(lambda *a: lstm_scan_pallas(*a, True),
                                  x_bf16, lengths, jax_p, gh, gc)
    dx, dparams = _port_lstm_grads(x, lengths, port_p, gh, gc,
                                   dtype=torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and ex.dtype == jnp.bfloat16
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(ex.astype(jnp.float32)),
                               atol=1e-6, rtol=2 ** -8)
    for name, expected in eparams.items():
        assert dparams[name].dtype == torch.float32
        np.testing.assert_allclose(dparams[name].numpy(),
                                   np.asarray(expected), err_msg=name,
                                   atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_saved_states_match_pallas_save_kernel(dtype):
    """Kernel A's plain version against ``_lstm_kernel_save`` in interpret
    mode: f32 gates (also at padded steps) and post-update masked carries."""
    batch, seq, emb, hid = 16, 7, 8, 16
    x, lengths, jax_p, port_p, _, _ = _lstm_grad_case(13, batch, seq, emb, hid)
    (eh, ec), expected = _lstm_scan_pallas_impl(
        jnp.asarray(x).astype(dtype), jnp.asarray(lengths), jax_p,
        interpret=True, save_states=True)
    t_dtype = getattr(torch, dtype)
    x_t = torch.from_numpy(x).to(t_dtype)
    x_proj = port_lstm.input_projections([x_t], [port_p]).to(t_dtype)
    got = port_lstm.lstm_recurrence_save_reference(
        x_proj, port_p["weight_hh"].to(t_dtype)[None],
        torch.from_numpy(lengths))
    tol = TOL if dtype == "float32" else dict(atol=2e-5, rtol=1e-5)
    for g, e in zip(got, (eh, ec) + tuple(expected)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g[0].numpy(), np.asarray(e), **tol)
    # At a padded step the carries repeat the last real step's.
    c_all = got[3][0]
    for b, n in enumerate(lengths):
        for t in range(n, seq):
            assert torch.equal(c_all[t, b], c_all[n - 1, b])


def test_lstm_backward_step_is_the_jax_step_body():
    """Kernel B's plain version on one step, keep = 1 and keep = 0."""
    rng = np.random.default_rng(14)
    dirs, batch, hid = 2, 5, 8
    gates, c_t, c_prev, dh, dc = (
        rng.standard_normal(shape).astype(np.float32)
        for shape in [(dirs, batch, 4 * hid)] + [(dirs, batch, hid)] * 4)
    keep = np.array([1, 0, 1, 1, 0], dtype=bool)
    dgates, dh_pass, dc_prev = port_lstm.lstm_backward_step_reference(
        *(torch.from_numpy(a) for a in (gates, c_t, c_prev, keep, dh, dc)))
    i, f, g, o = np.split(gates, 4, axis=-1)
    sig = lambda z: 1 / (1 + np.exp(-z))
    i, f, o, g, tc = sig(i), sig(f), sig(o), np.tanh(g), np.tanh(c_t)
    k = keep[None, :, None].astype(np.float32)
    dc_tot = dc * k + dh * k * o * (1 - tc * tc)
    expected = np.concatenate([dc_tot * g * i * (1 - i),
                               dc_tot * c_prev * f * (1 - f),
                               dc_tot * i * (1 - g * g),
                               dh * k * tc * o * (1 - o)], axis=-1)
    np.testing.assert_allclose(dgates.numpy(), expected, **TOL)
    np.testing.assert_allclose(dc_prev.numpy(), (1 - k) * dc + dc_tot * f,
                               **TOL)
    np.testing.assert_array_equal(dh_pass.numpy(), (1 - k) * dh)
    assert torch.all(dgates[:, ~torch.from_numpy(keep)] == 0)


@pytest.mark.parametrize("h,w,cin,cout,k,stride", [
    (12, 12, 3, 8, 3, 1),     # even conv output
    (13, 16, 4, 6, 3, 1),     # odd rows and even columns
    (15, 15, 5, 7, 3, 1),     # odd both: last row and column get zero
    (21, 22, 4, 6, 3, 2),     # stride 2
])
def test_conv_relu_pool_gradients_match_jax_fastgrad(h, w, cin, cout, k,
                                                     stride):
    """Integer-valued inputs: the conv output is full of ties (and of
    zeros after the ReLU), every product and sum is exact in f32, so dx
    and dw must be equal to the bit; db is a sum in another order of
    integers (exact here, 1e-6 relative allowed)."""
    rng = np.random.default_rng(15)
    x = rng.integers(-2, 3, (2, h, w, cin)).astype(np.float32)
    w_hwio = rng.integers(-1, 2, (k, k, cin, cout)).astype(np.float32)
    b = rng.integers(-1, 2, cout).astype(np.float32)
    hc, wc = (h - k) // stride + 1, (w - k) // stride + 1
    gout = rng.integers(-3, 4, (2, hc // 2, wc // 2, cout)).astype(np.float32)

    def loss(x_, w_, b_):
        out = jax_conv.conv_relu_pool_fastgrad(x_, w_, b_, stride)
        return jnp.sum(out * gout)

    ex, ew, eb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b))
    x_t = torch.from_numpy(x).requires_grad_()
    w_t = torch.from_numpy(
        w_hwio.transpose(3, 2, 0, 1).copy()).requires_grad_()
    b_t = torch.from_numpy(b).requires_grad_()
    out = port_conv.conv_relu_pool(x_t, w_t, b_t, stride)
    torch.sum(out * torch.from_numpy(gout)).backward()
    np.testing.assert_array_equal(x_t.grad.numpy(), np.asarray(ex))
    np.testing.assert_array_equal(
        w_t.grad.permute(2, 3, 1, 0).numpy(), np.asarray(ew))
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(eb), atol=0,
                               rtol=1e-6)


def test_relu_maxpool_backward_routes_a_tie_to_the_first_position():
    """Decided on cast(relu(y + b)), not on the raw value: -3 and -1 both
    become 0, and a window of zeros routes nothing (the gate is closed)."""
    y = torch.tensor([[5.0, 5.0, -3.0, -1.0, 9.0],
                      [5.0, 7.0, -1.0, -3.0, 9.0],
                      [9.0, 9.0, 9.0, 9.0, 9.0]]).reshape(1, 3, 5, 1)
    g = torch.tensor([2.0, 4.0]).reshape(1, 1, 2, 1)
    dz, db = port_conv.relu_maxpool_backward_reference(g, y, torch.zeros(1))
    expected = torch.zeros(3, 5)
    expected[1, 1] = 2.0  # the 7; the odd row and column stay zero
    assert torch.equal(dz.reshape(3, 5), expected)
    assert float(db) == 2.0
    # With bias 2 the second window is [0, 1, 1, 0]: first 1 in row-major.
    dz, db = port_conv.relu_maxpool_backward_reference(
        g, y, torch.full((1,), 2.0))
    expected[0, 3] = 4.0
    assert torch.equal(dz.reshape(3, 5), expected)
    assert float(db) == 6.0


@pytest.mark.parametrize("batch,grid,channels,glimpses", [
    (4, 6, 32, 2), (3, 5, 24, 1), (2, 4, 16, 3)])
def test_attention_pool_gradients_match_jax_vjp(batch, grid, channels,
                                                glimpses):
    rng = np.random.default_rng(16)
    v = rng.standard_normal((batch, grid, grid, channels)).astype(np.float32)
    att = rng.standard_normal((batch, grid, grid, glimpses)).astype(np.float32)
    g = rng.standard_normal((batch, glimpses * channels)).astype(np.float32)
    _, vjp = jax.vjp(jax_attention_pool.attention_pool_reference,
                     jnp.asarray(v), jnp.asarray(att))
    ev, eatt = vjp(jnp.asarray(g))
    v_t = torch.from_numpy(v).requires_grad_()
    att_t = torch.from_numpy(att).requires_grad_()
    port_attention_pool.attention_pool(v_t, att_t).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(v_t.grad.numpy(), np.asarray(ev), **TOL)
    np.testing.assert_allclose(att_t.grad.numpy(), np.asarray(eatt), **TOL)


@pytest.mark.parametrize("call", [
    lambda: port_conv.relu_maxpool_backward_cuda(
        torch.zeros(1, 2, 2, 2), torch.zeros(1, 4, 4, 2), torch.zeros(2)),
    lambda: lstm_recurrence_save_cuda(torch.zeros(1, 2, 3, 64),
                                      torch.zeros(1, 64, 16),
                                      torch.ones(3, dtype=torch.int32)),
    lambda: lstm_backward_step_cuda(
        torch.zeros(1, 2, 3, 64), torch.zeros(1, 2, 3, 16),
        torch.ones(3, dtype=torch.int32), torch.zeros(1, 3, 16),
        torch.zeros(1, 3, 16), torch.zeros(1, 2, 3, 64), 0),
], ids=["relu_maxpool_backward", "lstm_recurrence_save",
        "lstm_backward_step"])
def test_training_kernel_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()
