"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Small and ragged shapes that the serving path's own shapes (checked by
chip_smoke.py) do not reach: batches that do not fill a tile, odd conv
outputs, one to three glimpses. Every test here needs a GPU and skips
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
    relu_maxpool_cuda,
    relu_maxpool_reference,
)
from dl_vqa_tpu_torch.ops.lstm import (
    bilstm_final_cell,
    lstm_recurrence_reference,
)
from dl_vqa_tpu_torch.ops.lstm_cuda import lstm_recurrence_cuda


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
    expected = bilstm_final_cell(x, lengths, fwd, bwd,
                                 recurrence=lstm_recurrence_reference)
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
