"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Small and ragged shapes that the serving and training paths' own shapes
(checked by chip_smoke.py) do not reach: batches that do not fill a tile,
odd conv outputs, channel counts off the block size, one to eight
glimpses, all-short and all-full questions. Every test here needs a GPU and skips
without one. This file imports no JAX, so on a machine with a card and no
JAX it runs with:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import ctypes

import pytest
import torch

from dl_vqa_tpu_torch.ops import _native, vit_mlp_fused
from dl_vqa_tpu_torch.ops.attention_pool import (
    attention_pool_cuda,
    attention_pool_reference,
)
from dl_vqa_tpu_torch.ops.conv_fused import (
    conv_relu_pool,
    conv_relu_pool_fused_cuda,
    conv_relu_pool_fused_reference,
    conv_relu_pool_stem,
    conv_relu_pool_stem_cuda,
    conv_relu_pool_stem_reference,
    fused_plan,
    pack_conv_weight,
    pool_backward_vector_path,
    relu_maxpool,
    relu_maxpool_backward_cuda,
    relu_maxpool_backward_reference,
    relu_maxpool_cuda,
    relu_maxpool_reference,
    stem_mma_path,
)
from dl_vqa_tpu_torch.ops.layout_cases import (
    MODES,
    layout_case,
    layout_case_cuda,
    layout_case_reference,
    layout_cases,
    layout_cases_cuda,
)
from dl_vqa_tpu_torch.ops.lstm import (
    bilstm_final_cell,
    lstm_backward_step_reference,
    lstm_recurrence_grad,
    lstm_recurrence_reference,
    lstm_recurrence_save_reference,
    lstm_saved_state_backward,
)
from dl_vqa_tpu_torch.ops import lstm_cuda
from dl_vqa_tpu_torch.ops.lstm_cuda import (
    backward_step_vector_path,
    lstm_backward_step_cuda,
    lstm_backward_step_launcher,
    lstm_recurrence_cuda,
    lstm_recurrence_save_cuda,
    persistent_plan,
)
from dl_vqa_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_backward_cuda,
    vit_attention_backward_reference,
    vit_attention_cuda,
    vit_attention_reference,
)
from dl_vqa_tpu_torch.ops.vit_mlp_fused import (
    GRIDS as MLP_GRIDS,
    fused_ln_mlp,
    fused_ln_mlp_cuda,
    fused_ln_mlp_reference,
    row_plan,
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
    # f32 has no persistent plan: one grid per timestep, both directions in
    # each.
    assert lstm_recurrence_cuda.launches == before + x.shape[1]
    expected = bilstm_final_cell(x, lengths, fwd, bwd, plain=True)
    torch.testing.assert_close(got, expected, atol=1e-5, rtol=0)


# The persistent path (bf16 with a plan): every D, H and B below has one on
# an H100; T and the lengths' kind cycle over the shapes.
_PERSISTENT_SHAPES = [(d, h, b) for d in (1, 2) for h in (16, 48, 272, 1024)
                      for b in (1, 8, 63, 64, 65, 129, 512)]


def _persistent_inputs(device, directions, seq, batch, hidden, lengths,
                       seed=8):
    g = _gen(device, seed)
    x_proj = (torch.randn(directions, seq, batch, 4 * hidden, generator=g,
                          device=device) * 0.5).bfloat16()
    w_hh = ((torch.rand(directions, 4 * hidden, hidden, generator=g,
                        device=device) * 2 - 1) / hidden ** 0.5).bfloat16()
    if lengths == "ragged":  # 0 .. T, both ends present
        lens = torch.randint(0, seq + 1, (batch,), generator=g, device=device,
                             dtype=torch.int32)
        lens[0], lens[-1] = seq, 0
    else:
        lens = torch.full((batch,), 1 if lengths == "ones" else 0,
                          device=device, dtype=torch.int32)
    return x_proj, w_hh, lens


@pytest.mark.parametrize("seq", [1, 7, 23])
@pytest.mark.parametrize("directions,hidden,batch", _PERSISTENT_SHAPES)
def test_lstm_persistent_matches_plain(device, seq, directions, hidden,
                                       batch):
    """Kernels 1 and A on the persistent path against their plain versions
    (bf16 1e-2, as the per-step path); A's final (h, c) are kernel 1's
    bits; one launch a call."""
    kinds = ("ragged", "ones", "zero")
    lengths = kinds[(hidden + batch + seq) % 3]
    args = _persistent_inputs(device, directions, seq, batch, hidden,
                              lengths)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert persistent_plan(directions, hidden, torch.bfloat16, sms)
    before = (lstm_recurrence_cuda.launches,
              lstm_recurrence_save_cuda.launches)
    h, c = lstm_recurrence_cuda(*args)
    saved = lstm_recurrence_save_cuda(*args)
    assert (lstm_recurrence_cuda.launches,
            lstm_recurrence_save_cuda.launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert torch.equal(saved[0], h) and torch.equal(saved[1], c)
    for got, want in zip(saved, lstm_recurrence_save_reference(*args)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, atol=1e-2, rtol=0)
    if lengths == "zero":
        assert not h.any() and not c.any()


@pytest.mark.parametrize("save", [False, True])
def test_lstm_dispatch_rule(device, save):
    """bf16 at a shape with a plan: the persistent kernel, one launch; f32
    at the same shape: the per-step grids, one a timestep. Both agree with
    the plain version."""
    run = lstm_recurrence_save_cuda if save else lstm_recurrence_cuda
    x_proj, w_hh, lengths = _persistent_inputs(device, 2, 7, 33, 64,
                                               "ragged")
    for dtype, grids, tol in ((torch.bfloat16, 1, 1e-2),
                              (torch.float32, 7, 1e-5)):
        args = (x_proj.to(dtype), w_hh.to(dtype), lengths)
        before = run.launches
        got = run(*args)
        assert run.launches == before + grids
        want = (lstm_recurrence_save_reference if save
                else lstm_recurrence_reference)(*args)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=tol, rtol=0)


def test_lstm_persistent_refused_launch_raises(device, monkeypatch):
    """A plan for more SMs than the card has asks for a grid that cannot
    be resident at once: the cooperative launch refuses it and the wrapper
    raises, with nothing computed another way."""
    monkeypatch.setattr(lstm_cuda, "_sm_count", lambda device: 100_000)
    args = _persistent_inputs(device, 2, 3, 8, 1024, "ragged")
    assert persistent_plan(2, 1024, torch.bfloat16, 100_000)[1] > \
        torch.cuda.get_device_properties(0).multi_processor_count
    before = lstm_recurrence_cuda.launches
    with pytest.raises(RuntimeError, match="lstm_recurrence"):
        lstm_recurrence_cuda(*args)
    assert lstm_recurrence_cuda.launches == before
    monkeypatch.undo()
    h, c = lstm_recurrence_cuda(*args)  # the stream still works
    torch.testing.assert_close(h, lstm_recurrence_reference(*args)[0],
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("seq,batch", [(0, 8), (5, 0)])
def test_lstm_persistent_empty_calls_launch_nothing(device, seq, batch):
    args = _persistent_inputs(device, 2, seq, batch, 64, "ones")
    before = (lstm_recurrence_cuda.launches,
              lstm_recurrence_save_cuda.launches)
    h, c = lstm_recurrence_cuda(*args)
    saved = lstm_recurrence_save_cuda(*args)
    assert (lstm_recurrence_cuda.launches,
            lstm_recurrence_save_cuda.launches) == before
    assert h.shape == c.shape == (2, batch, 64)
    assert not h.any() and not c.any()
    assert saved[2].shape == (2, seq, batch, 256)


def test_lstm_persistent_rows_do_not_depend_on_the_batch(device):
    """A row's final (h, c) are the same bits at B = 1, 8, 64 and 512, H =
    1024: the plan, and so every row's arithmetic, ignores the batch."""
    x_proj, w_hh, lengths = _persistent_inputs(device, 2, 23, 512, 1024,
                                               "ragged")
    full = lstm_recurrence_cuda(x_proj, w_hh, lengths)
    for batch in (1, 8, 64):
        part = lstm_recurrence_cuda(x_proj[:, :, :batch].contiguous(), w_hh,
                                    lengths[:batch].contiguous())
        for a, b in zip(part, full):
            assert torch.equal(a, b[:, :batch]), batch


@pytest.mark.parametrize("save", [False, True])
def test_lstm_persistent_repeats_its_bits(device, save):
    """20 calls, each right after another kernel ran on the stream, give
    the same bits (the step barrier's ordering)."""
    run = lstm_recurrence_save_cuda if save else lstm_recurrence_cuda
    args = _persistent_inputs(device, 2, 23, 512, 1024, "ragged")
    first = run(*args)
    noise = torch.randn(2048, 2048, device=device)
    for _ in range(20):
        noise = noise @ noise.T / 2048
        again = run(*args)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


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


def _lstm_grids(dtype, directions, seq, hidden):
    """Grids one call of kernel 1 or A launches: 1 on the persistent path
    (bf16 with a plan), one a timestep on the per-step path."""
    plan = persistent_plan(directions, hidden, dtype,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    return seq if plan is None else min(seq, 1)


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
    assert lstm_recurrence_save_cuda.launches == before + _lstm_grids(
        dtype, directions, seq, hidden)
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


def _pool_backward_case(device, dtype, shape, seed=9):
    g = _gen(device, seed)
    y = _tied(shape, dtype, g, device)
    bias = _tied(shape[-1:], torch.float32, g, device) * 0.5
    cot = torch.randn(shape[0], shape[1] // 2, shape[2] // 2, shape[3],
                      generator=g, device=device).to(dtype)
    return cot, y, bias


def _assert_pool_backward(cot, y, bias, vector):
    """Kernel C on the path the mirror names, which the C entry names too:
    dz to the plain version's bits, db within 1e-5 of the sum of |g|."""
    batch, hc, wc, channels = y.shape
    lib = _native.library()
    dz_probe = torch.empty_like(y)
    pointers = (cot.data_ptr(), y.data_ptr(), bias.data_ptr(),
                dz_probe.data_ptr())
    assert pool_backward_vector_path(batch, hc, wc, channels, y.dtype,
                                     pointers) is vector
    assert lib.vqa_relu_maxpool_backward_vector(
        *pointers, batch, hc, wc, channels,
        {torch.float32: 0, torch.bfloat16: 1}[y.dtype]) == int(vector)
    before = (relu_maxpool_backward_cuda.launches,
              relu_maxpool_backward_cuda.launches_vector)
    dz, db = relu_maxpool_backward_cuda(cot, y, bias)
    assert relu_maxpool_backward_cuda.launches == before[0] + 2
    assert relu_maxpool_backward_cuda.launches_vector == before[1] + (
        2 if vector else 0)
    dz_ref, db_ref = relu_maxpool_backward_reference(cot, y, bias)
    assert torch.equal(dz, dz_ref)
    scale = float(cot.float().abs().sum(dim=(0, 1, 2)).max())
    torch.testing.assert_close(db, db_ref, atol=1e-5 * scale, rtol=0)
    return dz, db


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,vector", [
    (8, True), (16, True), (64, True), (128, True), (256, True),
    (1, False), (3, False), (12, False), (200, False), (300, False)])
@pytest.mark.parametrize("batch,hc,wc", [(1, 9, 7), (8, 6, 11), (67, 5, 4)])
def test_relu_maxpool_backward_vector_and_scalar_paths(device, dtype,
                                                       channels, vector,
                                                       batch, hc, wc):
    """Odd last rows and columns, one image to 67, both kernels of kernel
    C on tied values; the rule sends each channel count where it says."""
    _assert_pool_backward(*_pool_backward_case(
        device, dtype, (batch, hc, wc, channels)), vector)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["g", "y"])
def test_relu_maxpool_backward_view_off_a_16_byte_boundary(device, dtype,
                                                           which):
    """A contiguous view that starts one element into its storage takes
    the scalar kernel, with the same results."""
    cot, y, bias = _pool_backward_case(device, dtype, (3, 8, 9, 64))
    if which == "g":
        cot = torch.cat([cot.new_zeros(1), cot.reshape(-1)])[1:].view(
            cot.shape)
    else:
        y = torch.cat([y.new_zeros(1), y.reshape(-1)])[1:].view(y.shape)
    assert cot.is_contiguous() and y.is_contiguous()
    _assert_pool_backward(cot, y, bias, False)


@pytest.mark.parametrize("channels", [64, 128, 256])
def test_relu_maxpool_backward_vector_repeats_its_bits(device, channels):
    """The model's channel counts: db sums in a fixed order, so its bits
    (and dz's) are those of the first call, 20 calls later."""
    cot, y, bias = _pool_backward_case(device, torch.bfloat16,
                                       (16, 27, 27, channels))
    first = relu_maxpool_backward_cuda(cot, y, bias)
    noise = torch.randn(2048, 2048, device=device)
    for _ in range(20):
        noise = noise @ noise.T / 2048
        dz, db = relu_maxpool_backward_cuda(cot, y, bias)
        assert torch.equal(dz, first[0]) and torch.equal(db, first[1])


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


# Grids a kernel-5 call launches: bf16 one block per (image, head) for dq
# and then dk and dv; f32 a dq grid and a dk/dv grid.
_BWD_GRIDS = {torch.bfloat16: 1, torch.float32: 2}


def _batches_around_the_sm_count(device, heads):
    """The batches whose B * heads lie just below and just above the SM
    count: there the bf16 forward changes from blocks of four query slabs to
    a block a head."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return (sms - 1) // heads, sms // heads + 1


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
    """Also: one grid a call in bf16 (two in f32), and the same digits on a
    second run."""
    qkv, cot = _vit_inputs(device, dtype, batch, seq, heads)
    before = vit_attention_backward_cuda.launches
    got = vit_attention_backward_cuda(qkv, cot, heads)
    torch.cuda.synchronize()
    assert vit_attention_backward_cuda.launches == before + _BWD_GRIDS[dtype]
    assert got.shape == qkv.shape and got.dtype == dtype
    _assert_vit_close(got, vit_attention_backward_reference(qkv, cot, heads),
                      dtype, 2)
    assert torch.equal(got, vit_attention_backward_cuda(qkv, cot, heads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", [0, 1], ids=["below", "above"])
def test_vit_attention_around_the_sm_count(device, dtype, side):
    """B * H just below and just above the SM count, S = 196, H = 4."""
    batch = _batches_around_the_sm_count(device, 4)[side]
    qkv, cot = _vit_inputs(device, dtype, batch, 196, 4)
    _assert_vit_close(vit_attention_cuda(qkv, 4),
                      vit_attention_reference(qkv, 4), dtype, 1)
    _assert_vit_close(vit_attention_backward_cuda(qkv, cot, 4),
                      vit_attention_backward_reference(qkv, cot, 4), dtype, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attention_bits_do_not_depend_on_the_batch(device, dtype):
    """An image's kernel-4 output and kernel-5 gradient are the same bits in
    a batch of 1, 8 or 64 and at B * H just below and just above the SM
    count: a row's arithmetic does not depend on which block takes it."""
    heads = 4
    sizes = sorted({1, 8, 64, *_batches_around_the_sm_count(device, heads)})
    qkv, cot = _vit_inputs(device, dtype, sizes[-1], 196, heads)
    outs = [vit_attention_cuda(qkv[:n], heads) for n in sizes]
    grads = [vit_attention_backward_cuda(qkv[:n], cot[:n], heads)
             for n in sizes]
    for n, out, grad in zip(sizes, outs, grads):
        assert torch.equal(out, outs[-1][:n])
        assert torch.equal(grad, grads[-1][:n])


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
    """Through the Function on a CUDA tensor: one forward grid, the
    backward's grids, a non-contiguous cotangent made contiguous, and the
    plain path's gradient."""
    qkv, cot = _vit_inputs(device, dtype, 3, 50, 2)
    leaf = qkv.clone().requires_grad_(True)
    counts = (vit_attention_cuda.launches,
              vit_attention_backward_cuda.launches)
    out = vit_attention(leaf, 2)
    out.transpose(0, 1).backward(cot.transpose(0, 1))
    assert (vit_attention_cuda.launches,
            vit_attention_backward_cuda.launches) == (
                counts[0] + 1, counts[1] + _BWD_GRIDS[dtype])
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


# ------------------------------------------------ kernels 6 to 9, the fused ops

def _conv_case(device, dtype, batch, h, w, cin, cout, k, seed=11):
    g = _gen(device, seed)
    x = torch.randn(batch, h, w, cin, generator=g, device=device).to(dtype)
    weight = torch.randn(cout, cin, k, k, generator=g, device=device) \
        / (cin * k * k) ** 0.5
    bias = torch.randn(cout, generator=g, device=device) * 0.1
    return x, weight, bias


def _assert_fused_close(got, want, dtype):
    """f32: sums of up to a few thousand products in another order. bf16:
    the f32 sums agree as closely, so the rounded outputs are equal except
    where that difference moves the one rounding: a step at most."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        got, want = got.float(), want.float()
        assert bool((got - want).abs().le(
            2.0 ** -7 * want.abs().clamp(min=1e-3)).all())
        assert float((got != want).float().mean()) < 0.02


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,h,w,cin,cout,k", [
    (2, 37, 37, 16, 32, 3),   # the JAX test's odd conv size
    (2, 24, 24, 16, 32, 5),   # k = 5
    (1, 20, 41, 32, 64, 3),   # not square, two 16-column tiles and a bit
    (3, 19, 18, 48, 128, 3),  # three 16-channel slices, the widest block
    (2, 9, 11, 64, 256, 3),   # two channel tiles, one spatial tile
    (1, 4, 4, 16, 32, 3),     # one window
])
def test_conv_relu_pool_fused_matches_plain(device, dtype, batch, h, w, cin,
                                            cout, k):
    x, weight, bias = _conv_case(device, dtype, batch, h, w, cin, cout, k)
    before = conv_relu_pool_fused_cuda.launches
    got = conv_relu_pool_fused_cuda(x, weight, bias)
    assert conv_relu_pool_fused_cuda.launches == before + 1
    assert got.shape == (batch, (h - k + 1) // 2, (w - k + 1) // 2, cout)
    _assert_fused_close(got, conv_relu_pool_fused_reference(x, weight, bias),
                        dtype)


def test_conv_relu_pool_fused_f32_takes_channel_counts_off_the_tensor_tiles(
        device):
    x, weight, bias = _conv_case(device, torch.float32, 2, 15, 14, 20, 24, 3)
    _assert_fused_close(conv_relu_pool_fused_cuda(x, weight, bias),
                        conv_relu_pool_fused_reference(x, weight, bias),
                        torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_relu_pool_fused_autograd_matches_the_unfused_block(device,
                                                                 dtype):
    """Kernel 6 forward, then the unfused block's backward on the conv
    output computed again: the same cotangent gives the unfused block's
    gradients (cuDNN's weight gradient sums with atomics)."""
    x, weight, bias = _conv_case(device, dtype, 3, 21, 22, 16, 32, 3)
    g = torch.randn(3, 9, 10, 32, generator=_gen(device, 12),
                    device=device).to(dtype)
    grads = []
    for fused in (True, False):
        args = [t.clone().requires_grad_() for t in (x, weight, bias)]
        before = (conv_relu_pool_fused_cuda.launches,
                  relu_maxpool_backward_cuda.launches,
                  relu_maxpool_cuda.launches)
        conv_relu_pool(*args, fused=fused).backward(g)
        after = (conv_relu_pool_fused_cuda.launches,
                 relu_maxpool_backward_cuda.launches,
                 relu_maxpool_cuda.launches)
        assert tuple(a - b for a, b in zip(after, before)) == (
            (1, 2, 0) if fused else (0, 2, 1))
        grads.append([t.grad for t in args])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,h,w,cin,cout,k", [
    (2, 34, 34, 3, 8, 3), (2, 21, 21, 3, 8, 3), (2, 28, 28, 3, 8, 5),
    (3, 35, 50, 3, 64, 3),   # the reference stem's 64 channels, ragged tiles
    (1, 20, 20, 1, 16, 3), (2, 17, 19, 4, 40, 2), (1, 4, 4, 3, 8, 3)])
def test_conv_relu_pool_stem_matches_plain(device, dtype, batch, h, w, cin,
                                           cout, k):
    x, weight, bias = _conv_case(device, dtype, batch, h, w, cin, cout, k, 13)
    before = conv_relu_pool_stem_cuda.launches
    with torch.no_grad():
        got = conv_relu_pool_stem(x, weight, bias)
    assert conv_relu_pool_stem_cuda.launches == before + 1
    _assert_fused_close(got, conv_relu_pool_stem_reference(x, weight, bias),
                        dtype)


def test_conv_relu_pool_stem_takes_a_view_off_a_16_byte_boundary(device):
    """Rows of 3-channel pixels start anywhere; so may the tensor."""
    x, weight, bias = _conv_case(device, torch.bfloat16, 3, 22, 23, 3, 8, 3)
    view = x[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    _assert_fused_close(conv_relu_pool_stem_cuda(view, weight, bias),
                        conv_relu_pool_stem_reference(view, weight, bias),
                        torch.bfloat16)


def _stem_runs(x, weight, bias, mma):
    """Kernel 7 through its wrapper, on the path ``mma`` names (the mirror
    and the C entry both say so), counted as one grid."""
    cout, cin, k, _ = weight.shape
    code = {torch.float32: 0, torch.bfloat16: 1}[x.dtype]
    assert stem_mma_path(x.dtype, cin, cout, k) is mma
    assert _native.library().vqa_conv_relu_pool_stem_mma(
        cin, cout, k, code) == int(mma)
    before = (conv_relu_pool_stem_cuda.launches,
              conv_relu_pool_stem_cuda.launches_mma)
    got = conv_relu_pool_stem_cuda(x, weight, bias)
    assert conv_relu_pool_stem_cuda.launches == before[0] + 1
    assert conv_relu_pool_stem_cuda.launches_mma == before[1] + int(mma)
    return got


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cout", [8, 64, 128])
def test_conv_relu_pool_stem_tensor_cores_match_plain(device, batch, k,
                                                      cout):
    """Kernel 7's bf16 tensor-core kernel: pooled grids of 15 x 19 and 45 x
    34 windows (no multiple of its 4 x 16 tiles)."""
    h, w = (34, 43) if batch == 64 else (96, 74)
    x, weight, bias = _conv_case(device, torch.bfloat16, batch, h, w, 3,
                                 cout, k, seed=15)
    _assert_fused_close(_stem_runs(x, weight, bias, True),
                        conv_relu_pool_stem_reference(x, weight, bias),
                        torch.bfloat16)


@pytest.mark.parametrize("dtype,cin,cout,k,mma", [
    (torch.bfloat16, 1, 16, 9, True),    # K 81 -> 96, the largest taken
    (torch.bfloat16, 4, 40, 2, True),    # one k step, 8 channels a block
    (torch.bfloat16, 2, 96, 3, True),    # 32 channels a block
    (torch.bfloat16, 16, 64, 1, True),   # the widest window it takes
    (torch.bfloat16, 32, 64, 1, False),  # a filter row of 32 taps
    (torch.bfloat16, 4, 8, 5, False),    # K 100: the FMA kernel
    (torch.bfloat16, 12, 32, 3, False),  # K 108
    (torch.float32, 3, 64, 3, False),    # f32: the FMA kernel
])
def test_conv_relu_pool_stem_both_sides_of_the_rule(device, dtype, cin, cout,
                                                    k, mma):
    x, weight, bias = _conv_case(device, dtype, 3, 29, 30, cin, cout, k,
                                 seed=16)
    _assert_fused_close(_stem_runs(x, weight, bias, mma),
                        conv_relu_pool_stem_reference(x, weight, bias),
                        dtype)


@pytest.mark.parametrize("w", [37, 40])
def test_conv_relu_pool_stem_tensor_cores_take_an_unaligned_view(device, w):
    """A tensor that starts 2 bytes past a 16-byte boundary. With 37
    3-channel pixels a row, rows start anywhere and the window's pieces are
    realigned; with 40 (240 bytes) every row starts 2 bytes into a piece,
    and the window is read where the pieces land."""
    x, weight, bias = _conv_case(device, torch.bfloat16, 3, 35, w, 3, 64, 3,
                                 seed=17)
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
    view = flat[1:].view(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    _assert_fused_close(_stem_runs(view, weight, bias, True),
                        conv_relu_pool_stem_reference(view, weight, bias),
                        torch.bfloat16)


def test_conv_relu_pool_stem_pixels_do_not_depend_on_the_batch(device):
    """The stem's shape at B = 64 against B = 1 and 8 of the same images:
    the same bits, whatever blocks the persistent grid gives the tiles."""
    x, weight, bias = _conv_case(device, torch.bfloat16, 64, 224, 224, 3, 64,
                                 3, seed=18)
    full = conv_relu_pool_stem_cuda(x, weight, bias)
    for batch in (1, 8):
        part = conv_relu_pool_stem_cuda(x[:batch].contiguous(), weight, bias)
        assert torch.equal(part, full[:batch]), batch


def test_conv_relu_pool_stem_tensor_cores_repeat_their_bits(device):
    x, weight, bias = _conv_case(device, torch.bfloat16, 16, 224, 224, 3, 64,
                                 3, seed=19)
    _after_other_kernels(device,
                         lambda: conv_relu_pool_stem_cuda(x, weight, bias))


def _mlp_case(device, dtype, shape, hidden, seed=14):
    g = _gen(device, seed)
    dim = shape[-1]

    def rand(*size, scale=1.0):
        return torch.randn(*size, generator=g, device=device) * scale

    return (rand(*shape).to(dtype), rand(dim), rand(dim),
            rand(hidden, dim, scale=dim ** -0.5), rand(hidden),
            rand(dim, hidden, scale=hidden ** -0.5), rand(dim))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,hidden", [
    ((2, 196, 256), 1024), ((1, 1, 64), 64), ((3, 23, 128), 192),
    ((130, 64), 256), ((5, 13, 256), 64)])
def test_fused_ln_mlp_matches_plain(device, dtype, shape, hidden):
    """f32: sums over D and F in another order, relative to the largest
    output. bf16: ln and the hidden units are rounded on the way, and a
    last-place difference in f32 flips a few of those roundings, each of
    which moves an output by a fraction of its own rounding step: two
    steps of the largest output at most, and most outputs equal."""
    args = _mlp_case(device, dtype, shape, hidden)
    before = fused_ln_mlp_cuda.launches
    with torch.no_grad():
        got = fused_ln_mlp(*args)
    assert fused_ln_mlp_cuda.launches == before + MLP_GRIDS[dtype]
    _assert_mlp_close(got, fused_ln_mlp_reference(*args), dtype)


def _assert_mlp_close(got, want, dtype):
    """Kernel 8 against its plain version, as test_fused_ln_mlp_matches_plain
    states it."""
    assert got.shape == want.shape and got.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * top
    else:
        assert err <= 2 * 2.0 ** -8 * top
        assert float((got != want).float().mean()) < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [64, 128, 8])
@pytest.mark.parametrize("mode", MODES)
def test_layout_cases_are_exact(device, dtype, mode, channels):
    x = torch.randn(16, 32, channels, generator=_gen(device, 15),
                    device=device).to(dtype)
    before = layout_cases_cuda.launches
    got = layout_case(x, mode)
    assert layout_cases_cuda.launches == before + 1  # a batch of one
    want = layout_case_reference(x, mode)
    assert got.shape == want.shape and torch.equal(got, want)


def _fused_calls(device):
    x, weight, bias = _conv_case(device, torch.bfloat16, 1, 12, 12, 16, 32, 3)
    mlp = _mlp_case(device, torch.bfloat16, (2, 3, 64), 64)
    block = torch.zeros(4, 6, 8, device=device)
    return {
        "fused_stride": lambda: conv_relu_pool_fused_cuda(x, weight, bias, 2),
        "fused_narrow": lambda: conv_relu_pool_fused_cuda(
            x[..., :8].contiguous(), weight[:, :8], bias),
        "fused_bf16_channels": lambda: conv_relu_pool_fused_cuda(
            x, weight[:24], bias[:24]),
        "fused_strided_input": lambda: conv_relu_pool_fused_cuda(
            x.transpose(1, 2), weight, bias),
        "fused_f16": lambda: conv_relu_pool_fused_cuda(x.half(), weight, bias),
        "fused_filter_too_large": lambda: conv_relu_pool_fused_cuda(
            x[:, :2], weight, bias),
        "stem_channels": lambda: conv_relu_pool_stem_cuda(
            x, weight[:12], bias[:12]),
        "stem_cpu_weight": lambda: conv_relu_pool_stem_cuda(
            x, weight.cpu(), bias),
        "ln_mlp_width": lambda: fused_ln_mlp_cuda(*_mlp_case(
            device, torch.bfloat16, (2, 3, 96), 64)),
        "ln_mlp_hidden": lambda: fused_ln_mlp_cuda(*_mlp_case(
            device, torch.bfloat16, (2, 3, 64), 96)),
        "ln_mlp_f16": lambda: fused_ln_mlp_cuda(mlp[0].half(), *mlp[1:]),
        "ln_mlp_strided": lambda: fused_ln_mlp_cuda(
            mlp[0].transpose(0, 1), *mlp[1:]),
        "layout_channels": lambda: layout_case_cuda(block[..., :6], "shift"),
        "layout_odd_width": lambda: layout_case_cuda(block[:, :5], "split"),
        "layout_int": lambda: layout_case_cuda(block.int(), "shift"),
    }


@pytest.mark.parametrize("call", [
    "fused_stride", "fused_narrow", "fused_bf16_channels",
    "fused_strided_input", "fused_f16", "fused_filter_too_large",
    "stem_channels", "stem_cpu_weight", "ln_mlp_width", "ln_mlp_hidden",
    "ln_mlp_f16", "ln_mlp_strided", "layout_channels", "layout_odd_width",
    "layout_int"])
def test_fused_wrappers_reject_what_the_kernels_do_not_take(device, call):
    with pytest.raises(ValueError):
        _fused_calls(device)[call]()


def test_forward_only_ops_raise_where_a_gradient_would_be_recorded(device):
    x, weight, bias = _conv_case(device, torch.float32, 1, 12, 12, 3, 8, 3)
    with pytest.raises(RuntimeError, match="forward only"):
        conv_relu_pool_stem(x, weight.requires_grad_(), bias)
    mlp = _mlp_case(device, torch.float32, (2, 3, 64), 64)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_ln_mlp(mlp[0].requires_grad_(), *mlp[1:])


# Row groups of two warps (16 units a block), an odd count of 64-column
# chunks of h and two passes over the batch a step: the last chunk of a
# pass and the next pass's first share a slot of the staging ring.
_RING_REUSE_SHAPES = [(2, 576), (2, 704), (1, 1088)]


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("directions,hidden", _RING_REUSE_SHAPES)
def test_lstm_persistent_ring_reuse_between_passes(device, directions,
                                                   hidden, save):
    """At B = 512 these shapes take two passes a step with an odd chunk
    count: against the plain version (bf16 1e-2), then 20 calls, each
    after another kernel ran on the stream, give the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    units = persistent_plan(directions, hidden, torch.bfloat16, sms)[0]
    assert units == 16 and hidden // 64 % 2 == 1
    run = lstm_recurrence_save_cuda if save else lstm_recurrence_cuda
    plain = (lstm_recurrence_save_reference if save
             else lstm_recurrence_reference)
    args = _persistent_inputs(device, directions, 23, 512, hidden, "ragged")
    before = run.launches
    first = run(*args)
    assert run.launches == before + 1
    for got, want in zip(first, plain(*args)):
        torch.testing.assert_close(got, want, atol=1e-2, rtol=0)
    noise = torch.randn(2048, 2048, device=device)
    for _ in range(20):
        noise = noise @ noise.T / 2048
        again = run(*args)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


# The per-step bf16 grids (one 16-row tile a block up to 64 rows, four
# beyond), taken where a shape has no plan.
_PER_STEP_BF16_SHAPES = [(1, 1, 1, 16), (2, 5, 3, 32), (2, 7, 17, 48),
                         (1, 4, 40, 272), (2, 6, 64, 64), (2, 3, 67, 32),
                         (2, 5, 129, 32)]


@pytest.mark.parametrize("directions,seq,batch,hidden", _PER_STEP_BF16_SHAPES)
def test_lstm_per_step_bf16_matches_plain(device, monkeypatch, directions,
                                          seq, batch, hidden):
    """With no plan, bf16 takes one grid a timestep for kernels 1 and A:
    against the plain versions at 1e-2, A's final (h, c) kernel 1's bits."""
    monkeypatch.setattr(lstm_cuda, "persistent_plan", lambda *args: None)
    args = _persistent_inputs(device, directions, seq, batch, hidden,
                              "ragged")
    before = (lstm_recurrence_cuda.launches,
              lstm_recurrence_save_cuda.launches)
    h, c = lstm_recurrence_cuda(*args)
    saved = lstm_recurrence_save_cuda(*args)
    assert (lstm_recurrence_cuda.launches,
            lstm_recurrence_save_cuda.launches) == (before[0] + seq,
                                                    before[1] + seq)
    assert torch.equal(saved[0], h) and torch.equal(saved[1], c)
    for got, want in zip(saved, lstm_recurrence_save_reference(*args)):
        torch.testing.assert_close(got, want, atol=1e-2, rtol=0)


def test_lstm_bf16_without_a_plan_takes_the_per_step_grids(device):
    """D = 2, H = 2048 in bf16: W_hh (32 MiB) has no plan on an H100, so
    each call launches one grid a timestep, and agrees with the plain
    version."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert persistent_plan(2, 2048, torch.bfloat16, sms) is None
    args = _persistent_inputs(device, 2, 4, 5, 2048, "ragged")
    before = lstm_recurrence_cuda.launches
    got = lstm_recurrence_cuda(*args)
    assert lstm_recurrence_cuda.launches == before + 4
    for a, b in zip(got, lstm_recurrence_reference(*args)):
        torch.testing.assert_close(a, b, atol=1e-2, rtol=0)


# Kernels 8 and 6 on wgmma: the plans, ragged edges, bits and refusals.
def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _after_other_kernels(device, run, calls=20):
    """``run()`` once, then ``calls`` times more, each right after another
    kernel ran on the stream: the results are the first one's bits."""
    first = run()
    noise = torch.randn(2048, 2048, device=device)
    for _ in range(calls):
        noise = noise @ noise.T / 2048
        assert torch.equal(run(), first)


@pytest.mark.parametrize("warpgroups", [1, 2])
def test_fused_ln_mlp_ragged_rows_on_each_row_plan(device, warpgroups):
    """Row counts that are no multiple of a block's rows (64 or 128), on
    the plan of one and of two warpgroups a block."""
    sms = _sms()
    rows = 2 * 64 * sms + 37 if warpgroups == 2 else 64 * 5 + 3
    assert row_plan(rows, sms)[0] == warpgroups
    args = _mlp_case(device, torch.bfloat16, (rows, 256), 1024)
    before = fused_ln_mlp_cuda.launches
    with torch.no_grad():
        got = fused_ln_mlp(*args)
    assert fused_ln_mlp_cuda.launches == before + 2  # packing, then block
    _assert_mlp_close(got, fused_ln_mlp_reference(*args), torch.bfloat16)


def test_fused_ln_mlp_rows_do_not_depend_on_the_batch(device):
    """The ViT's token rows at B = 1, 8 (one warpgroup a block) and 512
    (two): the same image gives the same bits."""
    args = _mlp_case(device, torch.bfloat16, (512, 196, 256), 1024)
    assert row_plan(512 * 196, _sms())[0] == 2
    assert row_plan(8 * 196, _sms())[0] == 1
    full = fused_ln_mlp_cuda(*args)
    for batch in (1, 8):
        part = fused_ln_mlp_cuda(args[0][:batch].contiguous(), *args[1:])
        assert torch.equal(part, full[:batch]), batch


def test_fused_ln_mlp_repeats_its_bits(device):
    args = _mlp_case(device, torch.bfloat16, (128, 196, 256), 1024)
    _after_other_kernels(device, lambda: fused_ln_mlp_cuda(*args))


@pytest.mark.parametrize("dim,hidden", [(256, 1024), (128, 192), (64, 64)])
def test_fused_ln_mlp_packs_the_weights_as_the_plain_packing(device, dim,
                                                             hidden):
    """The C entry's first grid leaves in its scratch the bits of
    vit_mlp_fused.pack_weights, which the CPU tests check against the
    swizzle formula."""
    x, scale, shift, w1, b1, w2, b2 = _mlp_case(device, torch.bfloat16,
                                                (3, 5, dim), hidden)
    w1b, w2b = w1.bfloat16().contiguous(), w2.bfloat16().contiguous()
    packed = torch.empty(2, hidden * dim, dtype=torch.bfloat16,
                         device=device)
    out = torch.empty_like(x)
    code = _native.library().vqa_vit_mlp_fused(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w1b.data_ptr(),
        b1.data_ptr(), w2b.data_ptr(), b2.data_ptr(), out.data_ptr(),
        packed.data_ptr(), 15, dim, hidden, 1, 1,
        _native.stream_ptr(x.device))
    _native.check("vit_mlp_fused", code)
    want = vit_mlp_fused.pack_weights(w1b, w2b)
    assert torch.equal(packed[0], want[0].reshape(-1))
    assert torch.equal(packed[1], want[1].reshape(-1))


def test_fused_ln_mlp_refused_plan_raises(device, monkeypatch):
    """Four warpgroups a block would ask for 257 KiB of shared memory, more
    than a block may have: the C entry refuses the plan, nothing is
    launched, and the wrapper raises."""
    monkeypatch.setattr(vit_mlp_fused, "row_plan",
                        lambda rows, sms: (4, 256, -(-rows // 256)))
    args = _mlp_case(device, torch.bfloat16, (2, 196, 256), 1024)
    before = fused_ln_mlp_cuda.launches
    with pytest.raises(RuntimeError, match="vit_mlp_fused"):
        fused_ln_mlp_cuda(*args)
    assert fused_ln_mlp_cuda.launches == before
    monkeypatch.undo()
    _assert_mlp_close(fused_ln_mlp_cuda(*args),
                      fused_ln_mlp_reference(*args), torch.bfloat16)


# batch, h, w, Cin, Cout (k = 3) and the plan each takes.
_FUSED_PLAN_SHAPES = [
    (2, 54, 54, 128, 256),   # conv2: 4 x 4 windows a tile, 64 channels
    (3, 21, 23, 128, 256),   # the same, ragged both ways
    (2, 17, 30, 128, 128),   # 1 x 16 windows, 64-channel slices
    (2, 111, 111, 64, 128),  # conv1: 2 x 8 windows a tile, 128 channels
    (1, 25, 60, 64, 128),    # 1 x 16 windows, ragged rows
    (2, 13, 77, 32, 64),     # 2 x 8 windows, 64 channels, ragged
]


@pytest.mark.parametrize("batch,h,w,cin,cout", _FUSED_PLAN_SHAPES)
def test_conv_relu_pool_fused_plans_match_plain(device, batch, h, w, cin,
                                                cout):
    x, weight, bias = _conv_case(device, torch.bfloat16, batch, h, w, cin,
                                 cout, 3)
    before = conv_relu_pool_fused_cuda.launches
    got = conv_relu_pool_fused_cuda(x, weight, bias)
    assert conv_relu_pool_fused_cuda.launches == before + 1
    _assert_fused_close(got, conv_relu_pool_fused_reference(x, weight, bias),
                        torch.bfloat16)


# batch, h, w, Cin, Cout, k whose weights do not fit a block: streamed.
_FUSED_STREAM_SHAPES = [
    (2, 14, 14, 384, 64, 3),   # 64 channels a block, 64 a stage
    (3, 13, 15, 512, 128, 3),  # 128 channels, ragged
    (2, 12, 12, 128, 64, 5),   # k = 5
    (1, 17, 14, 256, 32, 5),   # k = 5, 32 channels, ragged
    (1, 16, 16, 48, 96, 7),    # k = 7, 16 channels a stage
    (1, 20, 17, 336, 96, 3),   # 48 channels a stage, across atoms
]


@pytest.mark.parametrize("batch,h,w,cin,cout,k", _FUSED_STREAM_SHAPES)
def test_conv_relu_pool_fused_streamed_weights_match_plain(device, batch, h,
                                                           w, cin, cout, k):
    """Shapes the mma.sync kernel 6 took, or wider, whose weights no block
    can hold: a step stages one filter row's weights beside the input."""
    assert fused_plan(h, w, cin, cout, k).stream
    x, weight, bias = _conv_case(device, torch.bfloat16, batch, h, w, cin,
                                 cout, k)
    before = conv_relu_pool_fused_cuda.launches
    got = conv_relu_pool_fused_cuda(x, weight, bias)
    assert conv_relu_pool_fused_cuda.launches == before + 1
    _assert_fused_close(got, conv_relu_pool_fused_reference(x, weight, bias),
                        torch.bfloat16)


@pytest.mark.parametrize("h,w,cin,cout,k", [
    (54, 54, 128, 256, 3), (111, 111, 64, 128, 3), (17, 30, 128, 128, 3),
    (13, 77, 32, 64, 3), (37, 37, 16, 32, 3), (24, 24, 16, 32, 5),
    (19, 18, 48, 128, 3), (9, 11, 64, 256, 3)]
    + [shape[1:] for shape in _FUSED_STREAM_SHAPES])
def test_conv_relu_pool_fused_plan_is_the_kernels(device, h, w, cin, cout,
                                                  k):
    """ops/conv_fused.py::fused_plan, which the CPU tests check, is the
    plan the C entry takes."""
    got = (ctypes.c_int * 6)()
    code = _native.library().vqa_conv_relu_pool_fused_plan(
        h, w, cin, cout, k, ctypes.cast(got, ctypes.c_void_p))
    plan = fused_plan(h, w, cin, cout, k)
    assert code == 0 and plan is not None
    assert list(got) == [plan.warp_rows, plan.warp_cols, plan.channels,
                         plan.ck, plan.shared, int(plan.stream)]


@pytest.mark.parametrize("size,cin,cout", [(111, 64, 128), (54, 128, 256),
                                           (54, 384, 256)])
def test_conv_relu_pool_fused_pixels_do_not_depend_on_the_batch(
        device, size, cin, cout):
    """The model's conv1 and conv2, and conv2's size at 384 input channels
    (weights streamed), at B = 1, 8 and 512: the grid and every
    warpgroup's tiles change, a pooled pixel's bits do not."""
    x, weight, bias = _conv_case(device, torch.bfloat16, 512, size, size,
                                 cin, cout, 3)
    full = conv_relu_pool_fused_cuda(x, weight, bias)
    for batch in (1, 8):
        part = conv_relu_pool_fused_cuda(x[:batch].contiguous(), weight, bias)
        assert torch.equal(part, full[:batch]), batch


@pytest.mark.parametrize("size,cin,cout", [(111, 64, 128), (54, 128, 256),
                                           (54, 384, 256)])
def test_conv_relu_pool_fused_repeats_its_bits(device, size, cin, cout):
    x, weight, bias = _conv_case(device, torch.bfloat16, 16, size, size, cin,
                                 cout, 3)
    _after_other_kernels(device,
                         lambda: conv_relu_pool_fused_cuda(x, weight, bias))


def test_conv_relu_pool_fused_refuses_more_shared_memory_than_a_block_has(
        device):
    """k = 26: two stages of one filter row of 32 channels' weights (104
    KiB each) and of four input windows exceed a block's shared memory. The wrapper raises before any launch, and the C entry, called
    directly, refuses the call too."""
    x, weight, bias = _conv_case(device, torch.bfloat16, 1, 30, 30, 16, 32,
                                 26)
    assert fused_plan(30, 30, 16, 32, 26) is None
    before = conv_relu_pool_fused_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        conv_relu_pool_fused_cuda(x, weight, bias)
    packed = pack_conv_weight(weight.bfloat16())
    bias32 = bias.float().contiguous()
    out = torch.empty(1, 2, 2, 32, dtype=torch.bfloat16, device=device)
    code = _native.library().vqa_conv_relu_pool_fused(
        x.data_ptr(), packed.data_ptr(), bias32.data_ptr(), out.data_ptr(), 1,
        30, 30, 16, 32, 26, 1, _native.stream_ptr(x.device))
    with pytest.raises(RuntimeError, match="conv_relu_pool_fused"):
        _native.check("conv_relu_pool_fused", code)
    assert conv_relu_pool_fused_cuda.launches == before


# Kernel B's vector and scalar kernels, bit for bit; kernel 9's batched
# entry.
def _backward_case(device, directions, seq, batch, hidden, lengths,
                   seed=16):
    """Saved states of a plain f32 forward and a ``(dh, dc)`` per step."""
    g = _gen(device, seed)
    x_proj = torch.randn(directions, seq, batch, 4 * hidden, generator=g,
                         device=device)
    w_hh = torch.randn(directions, 4 * hidden, hidden, generator=g,
                       device=device) / hidden ** 0.5
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    _, _, gates, c_all, h_all = lstm_recurrence_save_reference(
        x_proj, w_hh, lengths)
    carries = [tuple(torch.randn(directions, batch, hidden, generator=g,
                                 device=device) for _ in range(2))
               for _ in range(seq)]
    return gates, c_all, h_all, w_hh, lengths, carries


def _ragged(seq, batch):
    """Lengths with 0 and T - 1 among them and none longer, so step T - 1
    pads every row."""
    return [0, seq - 1] + [(3 * b) % seq for b in range(batch - 2)]


BACKWARD_BITS_CASES = [
    (2, 6, 5, 1024, True),   # the model's H
    (2, 5, 7, 32, True),
    (1, 4, 3, 8, True),
    (2, 5, 7, 6, False),     # H off the 4-unit vector: the scalar kernel
    (1, 3, 4, 1, False),
]


@pytest.mark.parametrize("directions,seq,batch,hidden,vector",
                         BACKWARD_BITS_CASES)
def test_lstm_backward_step_equals_plain_bits(device, directions, seq, batch,
                                              hidden, vector):
    """Every step (the last ones all padded, rows of length 0 among the
    others) fed the same inputs as the plain version: dgates, dh and dc are
    its bits (max_abs_err 0; a zero's sign aside, which == ignores), on the
    vector kernel where the rule says so and on the scalar one elsewhere."""
    gates, c_all, _, _, lengths, carries = _backward_case(
        device, directions, seq, batch, hidden, _ragged(seq, batch))
    assert backward_step_vector_path(directions, batch, hidden) is vector
    zeros = torch.zeros(directions, batch, hidden, device=device)
    dgates_all = torch.full_like(gates, float("nan"))
    for t in reversed(range(seq)):
        dh, dc = (x.clone() for x in carries[t])
        want = lstm_backward_step_reference(
            gates[:, t], c_all[:, t], c_all[:, t - 1] if t else zeros,
            t < lengths, dh, dc)
        before = (lstm_backward_step_cuda.launches,
                  lstm_backward_step_cuda.launches_vector)
        lstm_backward_step_cuda(gates, c_all, lengths, dh, dc, dgates_all, t)
        assert (lstm_backward_step_cuda.launches,
                lstm_backward_step_cuda.launches_vector) == (
                    before[0] + 1, before[1] + int(vector))
        for got, expected in zip((dgates_all[:, t], dh, dc), want):
            assert bool((got == expected).all()), t
    assert not dgates_all.isnan().any()


def test_lstm_backward_step_leaves_a_padded_row_s_carries_alone(device):
    """A padded row hands (dh, dc) on: the kernel neither reads nor writes
    them there, so NaN in a padded row's carry stays where it is and no
    real row's result sees it."""
    gates, c_all, _, _, lengths, carries = _backward_case(
        device, 2, 4, 6, 64, [4, 0, 2, 4, 1, 3])
    dgates_all = torch.empty_like(gates)
    dh, dc = (x.clone() for x in carries[2])
    padded = lengths <= 2
    dh[:, padded] = float("nan")
    dc[:, padded] = float("nan")
    want = lstm_backward_step_reference(
        gates[:, 2], c_all[:, 2], c_all[:, 1], 2 < lengths, dh, dc)
    lstm_backward_step_cuda(gates, c_all, lengths, dh, dc, dgates_all, 2)
    assert dh[:, padded].isnan().all() and dc[:, padded].isnan().all()
    assert bool((dgates_all[:, 2][:, padded] == 0).all())
    for got, expected in zip((dgates_all[:, 2], dh, dc), want):
        real = got[:, ~padded]
        assert bool((real == expected[:, ~padded]).all())


@pytest.mark.parametrize("hidden", [1024, 6])
def test_lstm_backward_step_launcher_is_the_checked_wrapper_s_bits(device,
                                                                   hidden):
    """The thin per-step entry, checked once for the whole backward, and
    the wrapper that checks on every call: the same bits and launches."""
    gates, c_all, _, _, lengths, carries = _backward_case(
        device, 2, 5, 9, hidden, _ragged(5, 9))
    results = []
    for thin in (True, False):
        dh, dc = (x.clone() for x in carries[-1])
        dgates_all = torch.empty_like(gates)
        before = lstm_backward_step_cuda.launches
        launch = lstm_backward_step_launcher(gates, c_all, lengths, dh, dc,
                                             dgates_all)
        for t in reversed(range(5)):
            if thin:
                launch(t)
            else:
                lstm_backward_step_cuda(gates, c_all, lengths, dh, dc,
                                        dgates_all, t)
        assert lstm_backward_step_cuda.launches == before + 5
        results.append((dgates_all, dh, dc))
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_lstm_backward_step_launcher_refuses_a_step_outside_the_sequence(
        device):
    gates, c_all, _, _, lengths, carries = _backward_case(
        device, 1, 3, 2, 8, [3, 1])
    dh, dc = (x.clone() for x in carries[0])
    launch = lstm_backward_step_launcher(gates, c_all, lengths, dh, dc,
                                         torch.empty_like(gates))
    before = lstm_backward_step_cuda.launches
    with pytest.raises(RuntimeError, match="lstm_backward_step"):
        launch(3)
    assert lstm_backward_step_cuda.launches == before


@pytest.mark.parametrize("which", ["gates_all", "c_all", "dh", "dc",
                                   "dgates_all", None])
def test_lstm_backward_step_rule_in_c_equals_the_mirror(device, which):
    """``vqa_lstm_backward_step_vector`` against
    ``backward_step_vector_path``, with one tensor a view 4 bytes off a
    16-byte boundary (it then takes the scalar kernel, still exact)."""
    directions, seq, batch, hidden = 2, 3, 4, 16
    gates, c_all, _, _, lengths, carries = _backward_case(
        device, directions, seq, batch, hidden, [3, 0, 1, 2])
    tensors = {"gates_all": gates, "c_all": c_all,
               "dh": carries[1][0].clone(), "dc": carries[1][1].clone(),
               "dgates_all": torch.empty_like(gates)}
    if which is not None:
        base = tensors[which]
        shifted = torch.empty(base.numel() + 1, device=device)[1:]
        tensors[which] = shifted.view_as(base).copy_(base)
    pointers = [tensors[k].data_ptr() for k in
                ("gates_all", "c_all", "dh", "dc", "dgates_all")]
    vector = bool(_native.library().vqa_lstm_backward_step_vector(
        *pointers, directions, batch, hidden))
    assert vector is backward_step_vector_path(directions, batch, hidden,
                                               pointers)
    assert vector is (which is None)
    want = lstm_backward_step_reference(
        gates[:, 1], c_all[:, 1], c_all[:, 0], 1 < lengths, tensors["dh"],
        tensors["dc"])
    before = lstm_backward_step_cuda.launches_vector
    lstm_backward_step_cuda(tensors["gates_all"], tensors["c_all"], lengths,
                            tensors["dh"], tensors["dc"],
                            tensors["dgates_all"], 1)
    assert lstm_backward_step_cuda.launches_vector == before + int(vector)
    for got, expected in zip((tensors["dgates_all"][:, 1], tensors["dh"],
                              tensors["dc"]), want):
        assert bool((got == expected).all())


@pytest.mark.parametrize("seq", [1, 6])
def test_lstm_saved_state_backward_kernel_path_equals_plain_path(device,
                                                                 seq):
    """The whole backward (kernel B and the products between its steps,
    dW_hh from views) on both paths: kernel B gives the plain bits, and the
    products are the same calls on the same operands."""
    batch, hidden = 7, 32
    gates, c_all, h_all, w_hh, lengths, carries = _backward_case(
        device, 2, seq, batch, hidden, _ragged(seq, batch))
    dh, dc = carries[-1]
    before = lstm_backward_step_cuda.launches_vector
    got = lstm_saved_state_backward(gates, c_all, h_all, w_hh, lengths, dh,
                                    dc, plain=False)
    assert lstm_backward_step_cuda.launches_vector == before + seq
    want = lstm_saved_state_backward(gates, c_all, h_all, w_hh, lengths, dh,
                                     dc, plain=True)
    assert bool((got[0] == want[0]).all())
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)
    if seq == 1:
        assert torch.count_nonzero(got[1]) == 0


def _layout_inputs(device, cases, seed=17):
    g = _gen(device, seed)
    return [torch.randn(*shape, generator=g, device=device).to(dtype)
            for shape, _, dtype in cases]


LAYOUT_BATCHES = {
    "probe": [((16, 32, c), m, torch.bfloat16)
              for c in (64, 128) for m in MODES],
    "mixed": [((3, 6, 4), "split", torch.float32),
              ((0, 4, 8), "shift", torch.bfloat16),
              ((5, 7, 8), "shift", torch.bfloat16),
              ((2, 2, 4), "merge", torch.float32),
              ((1, 2, 8), "strided", torch.bfloat16),
              ((33, 10, 16), "split", torch.bfloat16)],
    "one": [((16, 32, 64), "shift", torch.float32)],
}


@pytest.mark.parametrize("which", sorted(LAYOUT_BATCHES))
def test_layout_cases_in_one_launch_equal_the_per_case_calls(device, which):
    cases = LAYOUT_BATCHES[which]
    xs = _layout_inputs(device, cases)
    modes = [m for _, m, _ in cases]
    before = layout_cases_cuda.launches
    got = layout_cases(xs, modes)
    assert layout_cases_cuda.launches == before + 1
    for x, mode, out in zip(xs, modes, got):
        assert torch.equal(out, layout_case_cuda(x, mode))
        assert torch.equal(out, layout_case_reference(x, mode))


@pytest.mark.parametrize("call", [
    lambda d: layout_cases_cuda([torch.zeros(4, 6, 8, device=d)[..., :6]],
                                ["shift"]),
    lambda d: layout_cases_cuda([torch.zeros(4, 5, 8, device=d)], ["split"]),
    lambda d: layout_cases_cuda([torch.zeros(4, 6, 8, device=d).int()],
                                ["shift"]),
    lambda d: layout_cases_cuda([torch.zeros(4, 6, 8, device=d),
                                 torch.zeros(4, 6, 8)], ["shift", "shift"]),
], ids=["channels", "odd_width", "int", "two_devices"])
def test_layout_cases_refuse_what_the_kernel_does_not_take(device, call):
    before = layout_cases_cuda.launches
    with pytest.raises(ValueError):
        call(device)
    assert layout_cases_cuda.launches == before
