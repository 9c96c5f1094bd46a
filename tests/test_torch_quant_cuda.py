"""The quantized serving modes' kernels against their plain versions, on
the card: kernel 2's e4m3 and int8 modes and kernel D (the W8A8 conv
block, both its wgmma and its mma.sync kernel, each call counted on the
kernel ``w8a8_plan`` names) at small and ragged shapes the model's own
(checked by ``chip_smoke.py``) do not reach. Every test needs a GPU and
skips without one; no JAX is imported:

    python -m pytest --noconftest tests/test_torch_quant_cuda.py -q
"""

import pytest
import torch

from dl_vqa_tpu_torch.ops.conv_fused import (
    conv_relu_pool,
    relu_maxpool_backward_cuda,
    relu_maxpool_e4m3_cuda,
    relu_maxpool_e4m3_reference,
)
from dl_vqa_tpu_torch.ops.conv_int8 import (
    conv_relu_pool_w8a8_cuda,
    conv_relu_pool_w8a8_reference,
    quantize_relu_pool_cuda,
    quantize_relu_pool_reference,
    w8a8_plan,
)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _same_bits(got, want):
    """Equal values and NaN at the same places: tolerance 0."""
    got, want = got.float(), want.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep], want[keep])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 2, 2, 1), (3, 7, 9, 5), (2, 30, 31, 64)])
def test_e4m3_mode_equals_the_plain_bits(device, dtype, shape):
    gen = torch.Generator(device=device).manual_seed(1)
    y = (torch.randn(*shape, generator=gen, device=device) * 150).to(dtype)
    b = torch.randn(shape[-1], generator=gen, device=device)
    before = relu_maxpool_e4m3_cuda.launches
    got = relu_maxpool_e4m3_cuda(y, b)
    assert relu_maxpool_e4m3_cuda.launches == before + 1
    assert got.dtype == dtype
    _same_bits(got, relu_maxpool_e4m3_reference(y, b))


def test_e4m3_mode_overflows_to_nan_above_464(device):
    """One window a value, all four positions equal: 464 rounds to 448,
    anything above it is NaN, in the kernel and its plain version."""
    values = torch.tensor([464.0, 464.01, 465.0, 448.0, 1e5, 300.0, 2.0 ** -10,
                           2.0 ** -9, -3.0, 0.0], device=device)
    y = values[None, None, :, None].repeat_interleave(2, 2).repeat(1, 2, 1, 1)
    b = torch.zeros(1, device=device)
    got = relu_maxpool_e4m3_cuda(y.contiguous(), b).flatten()
    want = relu_maxpool_e4m3_reference(y, b).flatten()
    _same_bits(got, want)
    assert got[0] == 448.0 and torch.isnan(got[1:3]).all()
    assert got[3] == 448.0 and torch.isnan(got[4]) and got[5] == 288.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s_out", [0.5, 4.0, 300.0])
@pytest.mark.parametrize("shape", [(1, 2, 2, 1), (3, 7, 9, 5), (2, 30, 31, 64)])
def test_int8_mode_equals_the_plain_codes(device, dtype, shape, s_out):
    gen = torch.Generator(device=device).manual_seed(2)
    y = (torch.randn(*shape, generator=gen, device=device) * 3).to(dtype)
    b = torch.randn(shape[-1], generator=gen, device=device)
    before = quantize_relu_pool_cuda.launches
    got = quantize_relu_pool_cuda(y, b, s_out)
    assert quantize_relu_pool_cuda.launches == before + 1
    assert got.dtype == torch.int8
    assert torch.equal(got, quantize_relu_pool_reference(y, b, s_out))


@pytest.mark.parametrize("batch,size,cin,cout,k,stride", [
    (1, 5, 4, 8, 3, 1),       # one pooled pixel, Cin far below 32
    (2, 21, 36, 20, 3, 1),    # Cin and Cout off the tile, 9 pooled columns
    (3, 40, 64, 136, 3, 2),   # Cout over one block of 128 (a second N block)
    (2, 31, 48, 24, 3, 2),    # stride 2
    (1, 19, 128, 8, 2, 1),    # an even filter
    (2, 270, 32, 16, 3, 2),   # a wide row: 67 pooled columns, 9 groups, so
                              # a warp takes several items
])
def test_kernel_d_equals_the_plain_codes(device, batch, size, cin, cout, k,
                                         stride):
    """The mma.sync kernel, on the shapes the wgmma kernel does not take."""
    assert not _hold_kernel_d(device, batch, size, size, cin, cout, k, stride)


def _hold_kernel_d(device, batch, h, w_in, cin, cout, k, stride):
    """One call against the plain codes (tolerance 0), counted on the
    kernel that ``w8a8_plan`` names."""
    gen = torch.Generator(device=device).manual_seed(cin + cout)
    x = torch.randint(0, 128, (batch, h, w_in, cin), generator=gen,
                      device=device, dtype=torch.int8)
    w = torch.randn(cout, cin, k, k, generator=gen, device=device) * 0.05
    b = torch.randn(cout, generator=gen, device=device) * 0.2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wgmma = w8a8_plan(h, w_in, cin, cout, k, stride, sms).kernel == "wgmma"
    before = (conv_relu_pool_w8a8_cuda.launches,
              conv_relu_pool_w8a8_cuda.launches_wgmma)
    got = conv_relu_pool_w8a8_cuda(x, 3.0, w, b, stride, 4.0)
    assert (conv_relu_pool_w8a8_cuda.launches,
            conv_relu_pool_w8a8_cuda.launches_wgmma) == (
                before[0] + 1, before[1] + wgmma)
    want = conv_relu_pool_w8a8_reference(x, 3.0, w, b, stride, 4.0)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert 0 < (want > 0).float().mean() < 1
    return wgmma


@pytest.mark.parametrize("batch,h,w,cin,cout", [
    (1, 111, 111, 64, 128),   # conv1 of the model at B = 1
    (1, 54, 54, 128, 256),    # conv2 at B = 1
    (2, 20, 111, 64, 128),    # conv1's width at a few rows
    (3, 12, 54, 128, 256),    # conv2's width at a few rows
    (2, 17, 23, 64, 136),     # Cout off the 128-channel slice
    (2, 13, 300, 32, 64),     # a wide row: 149 pooled columns, Cin 32
    (64, 20, 20, 96, 256),    # several tiles a warpgroup; 3 channel steps
    (9, 30, 31, 128, 72),     # a slice of 128 for 72 channels
    (3, 40, 40, 64, 136),     # Cout over one slice of 128
    (2, 150, 150, 32, 16),    # a wide row: 74 pooled columns
])
def test_kernel_d_wgmma_equals_the_plain_codes(device, batch, h, w, cin,
                                               cout):
    assert _hold_kernel_d(device, batch, h, w, cin, cout, 3, 1)


def test_kernel_d_raises_on_what_it_does_not_take(device):
    x = torch.zeros(1, 9, 9, 6, device=device, dtype=torch.int8)
    w, b = torch.zeros(8, 6, 3, 3, device=device), torch.zeros(8, device=device)
    before = conv_relu_pool_w8a8_cuda.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        conv_relu_pool_w8a8_cuda(x, 1.0, w, b, 1, 1.0)
    with pytest.raises(ValueError, match="int8"):
        conv_relu_pool_w8a8_cuda(x.float(), 1.0, w, b, 1, 1.0)
    assert conv_relu_pool_w8a8_cuda.launches == before


def test_f8_block_trains_through_kernel_c(device):
    """The f8 block's forward is kernel 2's e4m3 mode, its backward kernel C
    on the saved conv output: gradients equal to the plain path's (the same
    routing, the same cuDNN gradient calls; 1e-5 of the norm for their
    atomics)."""
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(2, 20, 20, 16, generator=gen, device=device)
    w = torch.randn(32, 16, 3, 3, generator=gen, device=device) * 0.2
    b = torch.randn(32, generator=gen, device=device) * 0.1
    grads = []
    for plain in (False, True):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        e4m3, pool_bwd = (relu_maxpool_e4m3_cuda.launches,
                          relu_maxpool_backward_cuda.launches)
        out = conv_relu_pool(xs, ws, bs, 1, plain=plain, f8_store=True)
        out.square().sum().backward()
        ran = (relu_maxpool_e4m3_cuda.launches - e4m3,
               relu_maxpool_backward_cuda.launches - pool_bwd)
        assert ran == ((0, 0) if plain else (1, 2))
        grads.append((out.detach(), xs.grad, ws.grad, bs.grad))
    _same_bits(grads[0][0], grads[1][0])
    for got, want in zip(grads[0][1:], grads[1][1:]):
        assert float((got - want).norm() / want.norm()) <= 1e-5
