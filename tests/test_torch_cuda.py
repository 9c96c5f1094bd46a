"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Small and ragged shapes that the serving and training paths' own shapes
(checked by chip_smoke.py) do not reach: batches that do not fill a tile,
odd conv outputs, channel counts off the block size, one to eight
glimpses, all-short and all-full questions. Every test here needs a GPU and skips
without one. This file imports no JAX, so on a machine with a card and no
JAX it runs with:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from dl_vqa_tpu_torch.ops.attention_pool import (
    attention_pool_cuda,
    attention_pool_reference,
)
from dl_vqa_tpu_torch.ops.conv_fused import (
    relu_maxpool,
    relu_maxpool_backward_cuda,
    relu_maxpool_backward_reference,
    relu_maxpool_cuda,
    relu_maxpool_reference,
)
from dl_vqa_tpu_torch.ops.lstm import (
    bilstm_final_cell,
    lstm_backward_step_reference,
    lstm_recurrence_grad,
    lstm_recurrence_reference,
    lstm_recurrence_save_reference,
)
from dl_vqa_tpu_torch.ops.lstm_cuda import (
    lstm_backward_step_cuda,
    lstm_recurrence_cuda,
    lstm_recurrence_save_cuda,
)
from dl_vqa_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_backward_cuda,
    vit_attention_backward_reference,
    vit_attention_cuda,
    vit_attention_reference,
)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(device, seed=0):
    return torch.Generator(device=device).manual_seed(seed)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("directions,seq,batch,hidden", [
    (1, 1, 1, 16), (2, 5, 3, 32), (2, 7, 17, 48), (1, 4, 40, 272),
    (2, 3, 67, 32)])  # above 64 rows, bf16 blocks take four 16-row tiles
def test_lstm_recurrence_matches_plain(device, dtype, tol, directions, seq,
                                       batch, hidden):
    """f32: dot products of length H in another order. bf16: h is rounded
    to bf16 each step, and a last-place difference can flip it."""
    g = _gen(device)
    x_proj = torch.randn(directions, seq, batch, 4 * hidden, generator=g,
                         device=device).to(dtype)
    w_hh = (torch.randn(directions, 4 * hidden, hidden, generator=g,
                        device=device) / hidden ** 0.5).to(dtype)
    lengths = torch.randint(1, seq + 1, (batch,), generator=g, device=device,
                            dtype=torch.int32)
    lengths[0] = seq
    h, c = lstm_recurrence_cuda(x_proj, w_hh, lengths)
    hr, cr = lstm_recurrence_reference(x_proj, w_hh, lengths)
    torch.testing.assert_close(h, hr, atol=tol, rtol=0)
    torch.testing.assert_close(c, cr, atol=tol, rtol=0)
    assert lstm_recurrence_cuda.launches > 0


def test_lstm_zero_length_keeps_zero_state(device):
    x_proj = torch.randn(1, 3, 2, 64, device=device)
    w_hh = torch.randn(1, 64, 16, device=device)
    lengths = torch.tensor([0, 3], device=device, dtype=torch.int32)
    h, c = lstm_recurrence_cuda(x_proj, w_hh, lengths)
    assert torch.all(h[0, 0] == 0) and torch.all(c[0, 0] == 0)
    assert torch.any(c[0, 1] != 0)


def test_bilstm_dispatch_runs_the_kernel(device):
    g = _gen(device, 1)
    x = torch.randn(5, 6, 8, generator=g, device=device)
    lengths = torch.tensor([1, 6, 3, 2, 5], device=device)

    def params():
        return {"weight_ih": torch.randn(64, 8, generator=g, device=device),
                "weight_hh": torch.randn(64, 16, generator=g, device=device),
                "bias": torch.randn(64, generator=g, device=device)}

    fwd, bwd = params(), params()
    before = lstm_recurrence_cuda.launches
    got = bilstm_final_cell(x, lengths, fwd, bwd)
    # One grid per timestep, both directions in each.
    assert lstm_recurrence_cuda.launches == before + x.shape[1]
    expected = bilstm_final_cell(x, lengths, fwd, bwd, plain=True)
    torch.testing.assert_close(got, expected, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 2, 1), (2, 9, 7, 3),
                                   (3, 30, 31, 64), (2, 11, 10, 200)])
def test_relu_maxpool_is_exact(device, dtype, shape):
    g = _gen(device, 2)
    y = torch.randn(*shape, generator=g, device=device).to(dtype)
    b = torch.randn(shape[-1], generator=g, device=device) * 0.5
    got = relu_maxpool(y, b)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    torch.testing.assert_close(got, relu_maxpool_reference(y, b), atol=0,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,grid,channels,glimpses", [
    (1, 1, 1, 1), (3, 5, 33, 2), (2, 26, 256, 3), (4, 7, 300, 8)])
def test_attention_pool_matches_plain(device, dtype, batch, grid, channels,
                                      glimpses):
    g = _gen(device, 3)
    v = torch.randn(batch, grid, grid, channels, generator=g,
                    device=device).to(dtype)
    att = (torch.randn(batch, grid, grid, glimpses, generator=g,
                       device=device) * 3).to(dtype)
    torch.testing.assert_close(attention_pool_cuda(v, att),
                               attention_pool_reference(v, att),
                               atol=1e-5, rtol=1e-5)


def _lstm_case(device, dtype, directions, seq, batch, hidden, lengths):
    g = _gen(device, 4)
    x_proj = torch.randn(directions, seq, batch, 4 * hidden, generator=g,
                         device=device).to(dtype)
    w_hh = (torch.randn(directions, 4 * hidden, hidden, generator=g,
                        device=device) / hidden ** 0.5).to(dtype)
    if lengths == "ragged":
        lengths = torch.randint(1, seq + 1, (batch,), generator=g,
                                device=device, dtype=torch.int32)
        lengths[0], lengths[-1] = seq, 1
    else:
        lengths = torch.full((batch,), seq if lengths == "full" else 1,
                             device=device, dtype=torch.int32)
    return x_proj, w_hh, lengths


LSTM_TRAIN_CASES = [
    (1, 1, 1, 16, "ragged"), (2, 5, 3, 32, "ragged"), (2, 7, 17, 48, "ones"),
    (2, 6, 40, 64, "full"), (2, 3, 67, 32, "ragged")]  # 67: ragged 4-tile block


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("directions,seq,batch,hidden,lengths",
                         LSTM_TRAIN_CASES)
def test_lstm_save_mode_matches_plain_and_kernel_1(device, dtype, tol,
                                                   directions, seq, batch,
                                                   hidden, lengths):
    """Kernel A: final (h, c) are kernel 1's bits; the saved gates and
    carries match the plain save forward (tolerances as for kernel 1)."""
    args = _lstm_case(device, dtype, directions, seq, batch, hidden, lengths)
    before = lstm_recurrence_save_cuda.launches
    h, c, gates, c_all, h_all = lstm_recurrence_save_cuda(*args)
    assert lstm_recurrence_save_cuda.launches == before + seq
    h1, c1 = lstm_recurrence_cuda(*args)
    assert torch.equal(h, h1) and torch.equal(c, c1)
    expected = lstm_recurrence_save_reference(*args)
    for got, want in zip((h, c, gates, c_all, h_all), expected):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    assert torch.equal(c_all[:, -1], c) and torch.equal(h_all[:, -1], h)


@pytest.mark.parametrize("directions,seq,batch,hidden,lengths",
                         LSTM_TRAIN_CASES)
def test_lstm_backward_step_matches_plain(device, directions, seq, batch,
                                          hidden, lengths):
    """Kernel B on every step of a saved forward, fed the plain version's
    inputs: elementwise f32, so 1e-6 (expf/tanhf against torch's)."""
    x_proj, w_hh, lengths = _lstm_case(device, torch.float32, directions, seq,
                                       batch, hidden, lengths)
    _, _, gates, c_all, _ = lstm_recurrence_save_reference(x_proj, w_hh,
                                                           lengths)
    g = _gen(device, 5)
    dgates_all = torch.full_like(gates, float("nan"))
    zeros = torch.zeros(directions, batch, hidden, device=device)
    for t in reversed(range(seq)):
        dh = torch.randn(directions, batch, hidden, generator=g, device=device)
        dc = torch.randn(directions, batch, hidden, generator=g, device=device)
        want = lstm_backward_step_reference(
            gates[:, t], c_all[:, t], c_all[:, t - 1] if t else zeros,
            t < lengths, dh, dc)
        before = lstm_backward_step_cuda.launches
        lstm_backward_step_cuda(gates, c_all, lengths, dh, dc, dgates_all, t)
        assert lstm_backward_step_cuda.launches == before + 1
        for got, expected in zip((dgates_all[:, t], dh, dc), want):
            torch.testing.assert_close(got, expected, atol=1e-6, rtol=1e-6)
        padded = t >= lengths
        assert torch.all(dgates_all[:, t][:, padded] == 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("lengths", ["ragged", "ones", "full"])
def test_lstm_recurrence_gradients_match_plain_path(device, dtype, tol,
                                                    lengths):
    """The autograd Function end to end (kernels A and B and the products
    between them) against the plain path, with a nonzero dh_final. bf16:
    the two forwards differ by bf16 flips of h (see kernel 1), and the
    backward carries that difference through every step."""
    x_proj, w_hh, lengths = _lstm_case(device, torch.float32, 2, 6, 19, 32,
                                       lengths)
    g = _gen(device, 6)
    gh = torch.randn(2, 19, 32, generator=g, device=device)
    gc = torch.randn(2, 19, 32, generator=g, device=device)
    grads = []
    for plain in (False, True):
        x = x_proj.clone().requires_grad_(True)
        w = w_hh.clone().requires_grad_(True)
        h, c = lstm_recurrence_grad(x, w, lengths, dtype, plain=plain)
        ((h * gh).sum() + (c * gc).sum()).backward()
        grads.append((x.grad, w.grad))
    for got, want in zip(*grads):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def _tied(shape, dtype, gen, device):
    # A handful of bf16-exact levels, so most windows hold ties.
    levels = torch.tensor([-1.0, -0.5, 0.0, 0.25, 0.5, 1.0], device=device)
    idx = torch.randint(0, len(levels), shape, generator=gen, device=device)
    return levels[idx].to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 2, 2, 1), (2, 9, 7, 3), (3, 30, 31, 64), (2, 11, 10, 200),
    (1, 5, 4, 300), (67, 6, 6, 8)])
def test_relu_maxpool_backward_matches_plain(device, dtype, shape):
    """Kernel C: dz to the bit (a routing, no arithmetic); db sums the same
    rounded values in another order: 1e-5 relative to the sum of |g|."""
    g = _gen(device, 7)
    y = _tied(shape, dtype, g, device)
    bias = _tied(shape[-1:], torch.float32, g, device) * 0.5
    cot = torch.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3],
                      generator=g, device=device).to(dtype)
    before = relu_maxpool_backward_cuda.launches
    dz, db = relu_maxpool_backward_cuda(cot, y, bias)
    assert relu_maxpool_backward_cuda.launches == before + 2  # grids
    dz_ref, db_ref = relu_maxpool_backward_reference(cot, y, bias)
    assert dz.dtype == dtype and db.dtype == torch.float32
    assert torch.equal(dz, dz_ref)
    scale = float(cot.float().abs().sum(dim=(0, 1, 2)).max())
    torch.testing.assert_close(db, db_ref, atol=1e-5 * scale, rtol=0)
    # The odd last row and column get no gradient.
    if shape[1] % 2:
        assert torch.all(dz[:, -1] == 0)
    if shape[2] % 2:
        assert torch.all(dz[:, :, -1] == 0)


def test_relu_maxpool_autograd_runs_kernel_c(device):
    g = _gen(device, 8)
    y = _tied((2, 8, 9, 16), torch.float32, g, device).requires_grad_(True)
    bias = torch.zeros(16, device=device, requires_grad=True)
    before = relu_maxpool_backward_cuda.launches
    relu_maxpool(y, bias).sum().backward()
    assert relu_maxpool_backward_cuda.launches == before + 2  # grids
    yp = y.detach().clone().requires_grad_(True)
    bp = bias.detach().clone().requires_grad_(True)
    relu_maxpool(yp, bp, plain=True).sum().backward()
    assert torch.equal(y.grad, yp.grad)
    torch.testing.assert_close(bias.grad, bp.grad, atol=1e-4, rtol=0)


@pytest.mark.parametrize("call", [
    lambda d: lstm_recurrence_save_cuda(
        torch.zeros(1, 2, 3, 64, device=d, dtype=torch.float16),
        torch.zeros(1, 64, 16, device=d, dtype=torch.float16),
        torch.ones(3, device=d, dtype=torch.int32)),
    lambda d: lstm_recurrence_save_cuda(
        torch.zeros(1, 2, 3, 64), torch.zeros(1, 64, 16, device=d),
        torch.ones(3, device=d, dtype=torch.int32)),
    lambda d: lstm_recurrence_save_cuda(
        torch.zeros(1, 3, 2, 64, device=d).transpose(1, 2),
        torch.zeros(1, 64, 16, device=d),
        torch.ones(3, device=d, dtype=torch.int32)),
    lambda d: lstm_backward_step_cuda(
        torch.zeros(1, 2, 3, 64, device=d, dtype=torch.bfloat16),
        torch.zeros(1, 2, 3, 16, device=d),
        torch.ones(3, device=d, dtype=torch.int32),
        torch.zeros(1, 3, 16, device=d), torch.zeros(1, 3, 16, device=d),
        torch.zeros(1, 2, 3, 64, device=d), 0),
    lambda d: lstm_backward_step_cuda(
        torch.zeros(1, 2, 3, 64, device=d), torch.zeros(1, 2, 3, 16, device=d),
        torch.ones(3, device=d, dtype=torch.int32),
        torch.zeros(1, 3, 16, device=d), torch.zeros(1, 3, 16, device=d),
        torch.zeros(1, 2, 3, 64, device=d), 2),
    lambda d: relu_maxpool_backward_cuda(
        torch.zeros(1, 2, 2, 2, device=d, dtype=torch.bfloat16),
        torch.zeros(1, 4, 4, 2, device=d), torch.zeros(2, device=d)),
    lambda d: relu_maxpool_backward_cuda(
        torch.zeros(1, 2, 2, 2), torch.zeros(1, 4, 4, 2, device=d),
        torch.zeros(2, device=d)),
    lambda d: relu_maxpool_backward_cuda(
        torch.zeros(1, 2, 2, 2, device=d),
        torch.zeros(1, 4, 4, 2, device=d).transpose(1, 2),
        torch.zeros(2, device=d)),
], ids=["save_half", "save_cpu", "save_strided", "step_dtype", "step_range",
        "pool_bwd_dtype", "pool_bwd_cpu", "pool_bwd_strided"])
def test_training_wrappers_reject_what_the_kernels_do_not_take(device, call):
    with pytest.raises(ValueError):
        call(device)


@pytest.mark.parametrize("call", [
    lambda d: relu_maxpool_cuda(torch.zeros(1, 4, 4, 2, device=d,
                                            dtype=torch.float16),
                                torch.zeros(2, device=d)),
    lambda d: relu_maxpool_cuda(
        torch.zeros(1, 4, 4, 2, device=d).transpose(1, 2),
        torch.zeros(2, device=d)),
    lambda d: attention_pool_cuda(torch.zeros(1, 2, 2, 3, device=d),
                                  torch.zeros(1, 2, 2, 9, device=d)),
    lambda d: lstm_recurrence_cuda(torch.zeros(1, 2, 3, 40, device=d),
                                   torch.zeros(1, 40, 10, device=d),
                                   torch.ones(3, device=d, dtype=torch.int32)),
    lambda d: lstm_recurrence_cuda(torch.zeros(1, 2, 3, 64, device=d),
                                   torch.zeros(1, 64, 16, device=d),
                                   torch.ones(3, device=d)),
], ids=["half", "strided", "glimpses", "hidden16", "lengths_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(device, call):
    with pytest.raises(ValueError):
        call(device)


# Kernels 4 and 5 (ViT attention). Full width last; before it the shapes of
# the CPU tests and those that leave a tile ragged: fewer tokens than one
# tile, an exact tile, the largest S the kernels take.
VIT_SHAPES = [(4, 196, 4), (2, 50, 2), (3, 52, 1), (1, 5, 1), (2, 16, 2),
              (1, 33, 3), (2, 256, 2), (512, 196, 4)]


def _vit_inputs(device, dtype, batch, seq, heads, seed=7):
    g = _gen(device, seed)
    qkv = torch.randn(batch, seq, 3 * heads * 64, generator=g,
                      device=device).to(dtype)
    cot = torch.randn(batch, seq, heads * 64, generator=g,
                      device=device).to(dtype)
    return qkv, cot


def _assert_vit_close(got, want, dtype, steps):
    """f32: sums in another order, 1e-5 absolute on values of order 1.
    bf16: equal except where a last-place f32 difference moves a rounding
    (of e, w, dz or the output) by a step: within `steps` bf16 steps of
    the largest value, and fewer than 2 in 100 differ at all."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        return
    tol = steps * 2.0 ** -8 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert float((got != want).float().mean()) < 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,seq,heads", VIT_SHAPES)
def test_vit_attention_matches_plain(device, dtype, batch, seq, heads):
    qkv, _ = _vit_inputs(device, dtype, batch, seq, heads)
    before = vit_attention_cuda.launches
    got = vit_attention_cuda(qkv, heads)
    torch.cuda.synchronize()
    assert vit_attention_cuda.launches == before + 1
    assert got.shape == (batch, seq, heads * 64) and got.dtype == dtype
    _assert_vit_close(got, vit_attention_reference(qkv, heads), dtype, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,seq,heads", VIT_SHAPES)
def test_vit_attention_backward_matches_plain(device, dtype, batch, seq,
                                              heads):
    """Also: two grids a call, and the same digits on a second run."""
    qkv, cot = _vit_inputs(device, dtype, batch, seq, heads)
    before = vit_attention_backward_cuda.launches
    got = vit_attention_backward_cuda(qkv, cot, heads)
    torch.cuda.synchronize()
    assert vit_attention_backward_cuda.launches == before + 2
    assert got.shape == qkv.shape and got.dtype == dtype
    _assert_vit_close(got, vit_attention_backward_reference(qkv, cot, heads),
                      dtype, 2)
    assert torch.equal(got, vit_attention_backward_cuda(qkv, cot, heads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attention_heads_are_not_mixed(device, dtype):
    """Zeroing head 1's q, k and v lanes leaves head 0's output and
    gradients equal to the bit."""
    qkv, cot = _vit_inputs(device, dtype, 2, 52, 2)
    zeroed = qkv.clone()
    for part in range(3):
        zeroed[..., part * 128 + 64:part * 128 + 128] = 0
    a, b = (vit_attention_cuda(t, 2) for t in (qkv, zeroed))
    assert torch.equal(a[..., :64], b[..., :64])
    assert not torch.equal(a[..., 64:], b[..., 64:])
    da, db = (vit_attention_backward_cuda(t, cot, 2) for t in (qkv, zeroed))
    for part in range(3):
        lanes = slice(part * 128, part * 128 + 64)
        assert torch.equal(da[..., lanes], db[..., lanes])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attention_autograd_runs_kernels_4_and_5(device, dtype):
    """Through the Function on a CUDA tensor: one forward grid, two
    backward grids, a non-contiguous cotangent made contiguous, and the
    plain path's gradient."""
    qkv, cot = _vit_inputs(device, dtype, 3, 50, 2)
    leaf = qkv.clone().requires_grad_(True)
    counts = (vit_attention_cuda.launches,
              vit_attention_backward_cuda.launches)
    out = vit_attention(leaf, 2)
    out.transpose(0, 1).backward(cot.transpose(0, 1))
    assert (vit_attention_cuda.launches,
            vit_attention_backward_cuda.launches) == (counts[0] + 1,
                                                      counts[1] + 2)
    plain_leaf = qkv.clone().requires_grad_(True)
    vit_attention(plain_leaf, 2, plain=True).backward(cot)
    assert vit_attention_cuda.launches == counts[0] + 1
    _assert_vit_close(leaf.grad, plain_leaf.grad, dtype, 2)


@pytest.mark.parametrize("call", [
    lambda d: vit_attention_cuda(torch.zeros(1, 4, 3 * 32, device=d), 1),
    lambda d: vit_attention_cuda(
        torch.zeros(1, 4, 3 * 64, device=d, dtype=torch.float16), 1),
    lambda d: vit_attention_cuda(
        torch.zeros(1, 4, 6 * 64, device=d)[..., ::2], 1),
    lambda d: vit_attention_cuda(torch.zeros(1, 257, 3 * 64, device=d), 1),
    lambda d: vit_attention_cuda(torch.zeros(1, 4, 3 * 64), 1),
    lambda d: vit_attention_backward_cuda(
        torch.zeros(1, 4, 3 * 64, device=d), torch.zeros(1, 4, 64), 1),
    lambda d: vit_attention_backward_cuda(
        torch.zeros(1, 4, 3 * 64, device=d),
        torch.zeros(1, 4, 64, device=d, dtype=torch.bfloat16), 1),
    lambda d: vit_attention_backward_cuda(
        torch.zeros(1, 4, 3 * 64, device=d), torch.zeros(1, 4, 128, device=d),
        1),
    lambda d: vit_attention_backward_cuda(
        torch.zeros(1, 4, 3 * 64, device=d),
        torch.zeros(1, 4, 128, device=d)[..., ::2], 1),
], ids=["head_of_32", "half", "strided", "too_long", "cpu", "g_on_cpu",
        "g_dtype", "g_shape", "g_strided"])
def test_vit_wrappers_reject_what_the_kernels_do_not_take(device, call):
    with pytest.raises(ValueError):
        call(device)
