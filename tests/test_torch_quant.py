"""The port's quantized serving modes against the JAX package, on the CPU.

f8e4m3 storage (``conv_relu_pool_quantstore``), the int8 W8A8 CNN stem
(``ops/conv_int8.py``) and the int8 W8A8 ViT products
(``ops/vit_int8.py``): each function against its JAX original on the same
seeded numpy inputs, then the models' logits against ``vqa.apply``, the
calibrators, the STE gradient, the refusals, and kernel D's weight packing
read back by its fragment layout. Tolerances are stated at each test; the
integer codes are compared exactly.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig as JaxAttentionConfig,
    ClassifierConfig as JaxClassifierConfig,
    ImageConfig as JaxImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig as JaxTextConfig,
)
from dl_vqa_tpu.ops import conv_fused as jax_conv_fused
from dl_vqa_tpu.ops import conv_int8 as jax_int8
from dl_vqa_tpu.ops import vit_int8 as jax_vit_int8
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.ops import conv_int8, vit_int8
from dl_vqa_tpu_torch.ops.conv_fused import (
    E4M3_OVERFLOW,
    conv_relu_pool,
    conv_relu_pool_quantstore,
    relu_maxpool_e4m3_reference,
)
from dl_vqa_tpu_torch.utils.params import load_jax_params

NUM_TOKENS = 50


def _hwio(w_oihw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w_oihw.transpose(2, 3, 1, 0))


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    """Equal values, NaN where the other has NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


# ------------------------------------------------------------ weights

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conv_weight_codes_and_scales_equal_jax(seed):
    """Against the jitted JAX function, as the JAX model runs it: XLA
    computes ``amax / 127`` as ``amax * f32(1 / 127)`` there, which differs
    from the division in the last place for a few percent of the channels
    (op-by-op JAX divides)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((96, 8, 3, 3)) * 0.1).astype(np.float32)
    w[3] = 0.0  # an all-zero channel: scale 1, codes 0
    got_q, got_s = conv_int8.quantize_weights_per_channel(torch.from_numpy(w))
    want_q, want_s = jax.jit(jax_int8.quantize_weights_per_channel)(
        jnp.asarray(_hwio(w)))
    np.testing.assert_array_equal(_hwio(got_q.numpy()), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[3] == 1.0 and got_q.dtype == torch.int8


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_weight_codes_and_scales_equal_jax(seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)  # [out, in]
    got_q, got_s = conv_int8.quantize_weights_per_channel(torch.from_numpy(w))
    want_q, want_s = jax.jit(jax_vit_int8._quantize_weight)(jnp.asarray(w.T))
    np.testing.assert_array_equal(got_q.numpy().T, np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ------------------------------------------------------------ the pools

@pytest.mark.parametrize("s_out", [0.7, 3.0, 40.0])
@pytest.mark.parametrize("shape", [(2, 6, 8, 5), (1, 7, 9, 16)])
def test_quantize_relu_pool_codes_equal_jax(shape, s_out):
    """Kernel 2's int8 mode (its plain version): the same codes as JAX's
    ``quantize_relu_pool`` of ``y + b``, saturation at 127 included."""
    rng = np.random.default_rng(7)
    y = (rng.standard_normal(shape) * 5).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    got = conv_int8.quantize_relu_pool(torch.from_numpy(y),
                                       torch.from_numpy(b), s_out)
    want = jax_int8.quantize_relu_pool(jnp.asarray(y) + jnp.asarray(b), s_out)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if s_out == 0.7:
        assert (got.numpy() == 127).any()


def _jax_e4m3_store(y, b):
    """JAX's e4m3 block on the conv output ``y``: an identity 1 x 1 conv
    gives ``y`` back exactly (one product by 1 per sum), so this is the
    quantized store and pool of ``conv_relu_pool_quantstore`` alone."""
    c = y.shape[-1]
    eye = jnp.eye(c, dtype=jnp.float32).reshape(1, 1, c, c)
    return jax_conv_fused.conv_relu_pool_quantstore(
        jnp.asarray(y), eye, jnp.asarray(b), 1, jnp.float8_e4m3fn)


@pytest.mark.parametrize("seed", [0, 1])
def test_e4m3_store_bits_equal_jax(seed):
    """Kernel 2's e4m3 mode (its plain version) against JAX's quantized
    store: equal bits, normals and subnormals, with NaN wherever a value of
    the window exceeds 464 (JAX's cast overflows to NaN there; torch's
    saturates to 448 and the port puts the NaN back)."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((2, 10, 12, 6)) * 60).astype(np.float32)
    y[0, 0, 0, :] = [464.0, 464.01, 470.0, 1e4, 447.0, 2.0 ** -10]
    y[1, :, :, 5] *= 1e-3  # subnormal e4m3 values
    b = (rng.standard_normal(6) * 3).astype(np.float32)
    got = relu_maxpool_e4m3_reference(torch.from_numpy(y),
                                      torch.from_numpy(b)).numpy()
    want = np.asarray(_jax_e4m3_store(y, b))
    _same_bits(got, want)
    assert np.isnan(want).any() and np.isnan(got[0, 0, 0, 3])  # 1e4
    z = y + b
    assert E4M3_OVERFLOW == 464.0
    assert (np.isnan(got) == (np.max(
        z[:, :10, :12].reshape(2, 5, 2, 6, 2, 6), axis=(2, 4)) > 464)).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantstore_block_matches_jax(dtype):
    """The whole f8 block (conv, then the e4m3 store and pool) in the compute
    dtype: the JAX conv and the port's sum in another order, so a last-place
    difference may move an e4m3 rounding by one step (1/8 of the element,
    relative); at most 1% of the elements may differ, none by more."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 12, 4)).astype(np.float32)
    w = (rng.standard_normal((8, 4, 3, 3)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_conv_fused.conv_relu_pool_quantstore(
        jnp.asarray(x, jdt), jnp.asarray(_hwio(w), jdt), jnp.asarray(b), 1,
        jnp.float8_e4m3fn).astype(jnp.float32))
    got = conv_relu_pool_quantstore(torch.from_numpy(x).to(tdt),
                                    torch.from_numpy(w),
                                    torch.from_numpy(b)).float().numpy()
    differ = got != want
    assert differ.mean() <= 0.01
    np.testing.assert_allclose(got, want, rtol=0.125, atol=2.0 ** -9)


@pytest.mark.parametrize("stride", [1, 2])
def test_quantstore_ste_gradient_matches_jax(stride):
    """The f8 block's backward is the exact gradient of the unquantized
    block, JAX's ``_quantstore_bwd``: f32, atol 1e-5 and rtol 1e-4 (sums
    in another order)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, 13, 4)).astype(np.float32)
    w = (rng.standard_normal((6, 4, 3, 3)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(6) * 0.1).astype(np.float32)
    out_shape = np.asarray(jax_conv_fused.conv_relu_pool_quantstore(
        jnp.asarray(x), jnp.asarray(_hwio(w)), jnp.asarray(b), stride,
        jnp.float8_e4m3fn)).shape
    g = rng.standard_normal(out_shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x_, w_, b_: jax_conv_fused.conv_relu_pool_quantstore(
            x_, w_, b_, stride, jnp.float8_e4m3fn),
        jnp.asarray(x), jnp.asarray(_hwio(w)), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = conv_relu_pool(xt, wt, bt, stride, f8_store=True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), _hwio_inv(np.asarray(dw)),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db), atol=1e-5,
                               rtol=1e-4)


def _hwio_inv(w_hwio: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))


# ------------------------------------------------------------ kernel D

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin,cout", [(8, 12), (36, 20), (64, 24)])
def test_w8a8_block_codes_equal_jax(cin, cout, stride):
    """Kernel D's plain version from the same int8 input: the same codes as
    JAX's ``conv_relu_pool_w8a8`` jitted, as the JAX model runs it (the
    integer conv is exact on both sides and the epilogue rounds once on
    both: :func:`test_w8a8_epilogue_rounds_once_as_jitted_xla_does`)."""
    rng = np.random.default_rng(cin + stride)
    x_q = rng.integers(0, 128, (2, 15, 15, cin)).astype(np.int8)
    w = (rng.standard_normal((cout, cin, 3, 3)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.2).astype(np.float32)
    s_in, s_out = 3.1, 5.3
    got = conv_int8.conv_relu_pool_w8a8(
        torch.from_numpy(x_q), s_in, torch.from_numpy(w), torch.from_numpy(b),
        stride, s_out)
    want = jax.jit(jax_int8.conv_relu_pool_w8a8, static_argnums=(1, 4, 5))(
        jnp.asarray(x_q), s_in, jnp.asarray(_hwio(w)), jnp.asarray(b),
        stride, s_out)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < (got.numpy() > 0).mean() < 1


def test_w8a8_epilogue_rounds_once_as_jitted_xla_does():
    """The epilogue ``f32(acc) * (w_scale * (s_in / 127)) + b`` as XLA
    computes it on the CPU in a jitted program (the expression of
    ``conv_relu_pool_w8a8`` and ``w8a8_linear``; the JAX entry points run
    the model jitted) is one fused multiply-add: it equals the port's
    ``fma_f32`` on every element, and a quarter of the elements differ from
    two f32 roundings (which op-by-op JAX gives), so the test tells the two
    apart. Kernel D rounds once too (``__fmaf_rn``)."""
    rng = np.random.default_rng(11)
    n, s_in = 200_000, 3.7
    acc = rng.integers(-2 ** 21, 2 ** 21, n).astype(np.int32)
    w_scale = (rng.random(n) * 0.01 + 1e-4).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    xla = np.asarray(jax.jit(
        lambda a, w, bb: a.astype(jnp.float32) * (w * (s_in / 127.0)) + bb)(
            acc, w_scale, b))
    mult = torch.from_numpy(w_scale) * conv_int8.f32(s_in / 127.0)
    acc32, b32 = torch.from_numpy(acc).float(), torch.from_numpy(b)
    two_roundings = (acc32 * mult + b32).numpy()
    assert (two_roundings != xla).mean() > 0.1
    np.testing.assert_array_equal(conv_int8.fma_f32(acc32, mult, b32).numpy(),
                                  xla)


@pytest.mark.parametrize("cin,cout,k", [(8, 12, 3), (36, 20, 3), (64, 136, 2)])
def test_packed_weight_read_back_by_the_fragment_layout(cin, cout, k):
    """Kernel D's B operand: lane l of an 8-channel tile holds channel l / 4
    at k = 4 (l % 4) + {0..3} in its first register and k + 16 in its
    second; reading the packed bytes back so gives the [K, Cout] matrix,
    K ordered (di, dj, ci) with Cin padded to 32, zero in the padding."""
    rng = np.random.default_rng(cin)
    w_q = torch.from_numpy(
        rng.integers(-127, 128, (cout, cin, k, k)).astype(np.int8))
    packed = conv_int8.pack_int8_weight(w_q).numpy()
    cin_pad = -(-cin // 32) * 32
    ntiles, ksteps = packed.shape[:2]
    assert ntiles * 8 % 128 == 0 and ntiles * 8 >= cout
    assert ksteps == k * k * cin_pad // 32
    matrix = np.zeros((ksteps * 32, ntiles * 8), np.int64)
    for lane in range(32):
        for reg in range(2):
            for e in range(4):
                kk = (32 * np.arange(ksteps)[None, :] + 16 * reg
                      + 4 * (lane % 4) + e)
                n = 8 * np.arange(ntiles)[:, None] + lane // 4
                matrix[kk, n] = packed[:, :, lane, 4 * reg + e]
    want = np.zeros((k, k, cin_pad, ntiles * 8), np.int64)
    want[:, :, :cin, :cout] = w_q.numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(matrix, want.reshape(-1, ntiles * 8))


# ------------------------------------------------------------ the stems

def _stem_params(seed, channels=(3, 8, 12, 16)):
    rng = np.random.default_rng(seed)
    image = {}
    for i in range(len(channels) - 1):
        w = (rng.standard_normal((channels[i + 1], channels[i], 3, 3))
             * 0.3).astype(np.float32)
        b = (rng.standard_normal(channels[i + 1]) * 0.1).astype(np.float32)
        image[f"conv{i}"] = (w, b)
    return image


class _Conv(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w))
        self.bias = torch.nn.Parameter(torch.from_numpy(b))


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_stem_forward_matches_jax(stride):
    """The whole int8 stem in f32 from the same images, against JAX's
    jitted: conv0's f32 sums run in another order than XLA's, which can
    move one code by 1 where a value sits on a rounding boundary; seen:
    none. So: equal outputs for all but 1% of the elements, none off by
    more than one code of the last block's scale."""
    rng = np.random.default_rng(5)
    size = 40 if stride == 1 else 96
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    image = _stem_params(1)
    scales = (4.0, 2.5, 1.5)
    got = conv_int8.int8_stem_forward(
        [_Conv(w, b) for w, b in image.values()], torch.from_numpy(x),
        scales, stride, torch.float32).numpy()
    want = np.asarray(jax.jit(
        jax_int8.int8_stem_forward, static_argnums=(2, 3, 4))(
            {k: {"w": jnp.asarray(_hwio(w)), "b": jnp.asarray(b)}
             for k, (w, b) in image.items()}, jnp.asarray(x), scales, stride,
            jnp.float32))
    assert got.shape == want.shape
    assert (got != want).mean() <= 0.01
    np.testing.assert_allclose(got, want, atol=scales[-1] / 127 * 1.001,
                               rtol=0)


def _vit_block_params(seed, dim=32):
    rng = np.random.default_rng(seed)
    return {name: ((rng.standard_normal((o, i)) / np.sqrt(i)).astype(
        np.float32), (rng.standard_normal(o) * 0.1).astype(np.float32))
        for name, (i, o) in {"a": (dim, 3 * dim), "b": (4 * dim, dim)}.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s_in", [0.5, 2.0])
def test_w8a8_linear_matches_jax(dtype, s_in):
    """The same int8 product on both sides (exact) and the same epilogue,
    one rounding as jitted XLA gives it: equal in f32; in bf16 the one
    rounding of equal f32 values is equal too."""
    rng = np.random.default_rng(9)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    x = rng.standard_normal((3, 12, 32)).astype(np.float32)
    (w, b), _ = _vit_block_params(2).values()
    got = vit_int8.w8a8_linear(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(w), torch.from_numpy(b),
                               s_in, tdt).float().numpy()
    want = np.asarray(jax.jit(
        jax_vit_int8.w8a8_linear, static_argnums=(3, 4))(
            jnp.asarray(x, jdt), jnp.asarray(w.T), jnp.asarray(b), s_in,
            jdt).astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


def test_w8a8_linear_raises_for_a_shape_the_int8_product_does_not_take():
    w, b = torch.zeros(8, 12), torch.zeros(8)
    with pytest.raises(ValueError, match="multiples of 8"):
        vit_int8.w8a8_linear(torch.ones(2, 20, 12), w, b, 1.0, torch.float32)
    with pytest.raises(ValueError, match="more than 16 rows"):
        vit_int8.w8a8_linear(torch.ones(1, 16, 16), torch.zeros(8, 16), b,
                             1.0, torch.float32)


# ------------------------------------------------------------ models

def _cnn_cfg(store="compute", scales=()):
    return JaxModelConfig(
        text=JaxTextConfig(question_features=32, embedding_features=16,
                           dropout=0.0),
        image=JaxImageConfig(num_channels=(3, 8, 12, 16), dropout=0.0,
                             store_dtype=store, quant_scales=scales),
        attention=JaxAttentionConfig(hidden_dim=24, glimpses=2, dropout=0.0),
        classifier=JaxClassifierConfig(hidden_dim=20, dropout=0.0),
        max_answers=30, image_size=64, num_tokens=NUM_TOKENS)


def _vit_cfg(store="compute", scales=(), layers=2):
    return JaxModelConfig(
        text=JaxTextConfig(question_features=16, embedding_features=8,
                           dropout=0.0),
        image=JaxImageConfig(encoder="vit", num_channels=(3, 128),
                             patch_size=16, num_layers=layers, num_heads=2,
                             dropout=0.0, store_dtype=store,
                             quant_scales=scales),
        attention=JaxAttentionConfig(hidden_dim=12, glimpses=2, dropout=0.0),
        classifier=JaxClassifierConfig(hidden_dim=20, dropout=0.0),
        max_answers=30, image_size=64, num_tokens=NUM_TOKENS)


def _port(jax_cfg, params):
    model = VqaNet(ModelConfig.from_meta_dict(dataclasses.asdict(jax_cfg)),
                   device="cpu")
    return load_jax_params(model, params)


def _inputs(seed=0, batch=3, size=64):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    lengths = np.array([7, 1, 5, 3][:batch], dtype=np.int32)
    questions = rng.integers(1, NUM_TOKENS, (batch, 7)).astype(np.int32)
    questions *= np.arange(7)[None, :] < lengths[:, None]
    return images, questions, lengths


def _params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(seed), cfg))


def _logits(cfg, params, inputs, dtype="f32"):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(vqa.apply(params, cfg, *(jnp.asarray(a) for a in inputs),
                                train=False, compute_dtype=jdt))
    with torch.no_grad():
        got = _port(cfg, params)(*(torch.from_numpy(a) for a in inputs),
                                 compute_dtype=tdt).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_cnn_calibration_equals_jax(seed):
    """``calibrate_stem_scales`` on the same params and images: the amaxes
    of the exact block, 1e-6 relative (f32 sums in another order)."""
    cfg = _cnn_cfg()
    params = _params(cfg, seed)
    images = _inputs(seed)[0]
    want = jax_int8.calibrate_stem_scales(params, cfg, jnp.asarray(images),
                                          dtype=jnp.float32)
    got = conv_int8.calibrate_stem_scales(_port(cfg, params), images,
                                          dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("layers", [1, 2])
def test_vit_calibration_equals_jax(layers):
    cfg = _vit_cfg(layers=layers)
    params = _params(cfg)
    images = _inputs()[0]
    want = jax_vit_int8.calibrate_vit_scales(params, cfg, jnp.asarray(images),
                                             dtype=jnp.float32)
    got = vit_int8.calibrate_vit_scales(_port(cfg, params), images,
                                        dtype=torch.float32)
    assert len(got) == 4 * layers
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_f8_model_logits_match_jax_apply(dtype):
    """f8 storage through the whole model: the e4m3 roundings agree but
    for the conv sums' order (f32) and bf16's own flips, as in
    :func:`test_quantstore_block_matches_jax`; through the attention and
    the classifier that gives atol 2e-4 (f32) and 1e-3 (bf16)."""
    cfg = _cnn_cfg("f8e4m3")
    got, want = _logits(cfg, _params(cfg), _inputs(), dtype)
    assert got.shape == (3, 30)
    np.testing.assert_allclose(got, want, atol=2e-4 if dtype == "f32"
                               else 1e-3, rtol=0)
    base_cfg = _cnn_cfg()
    base, _ = _logits(base_cfg, _params(base_cfg), _inputs(), dtype)
    assert np.abs(got - base).max() > 0  # the store changed something


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_cnn_model_logits_match_jax_apply(dtype):
    """The int8 stem through the whole model, scales calibrated by the JAX
    package: a code moved by conv0's sum order moves the logits by a few
    1e-5 here; atol 2e-4 (f32), 1e-3 (bf16)."""
    base = _cnn_cfg()
    params = _params(base)
    scales = jax_int8.calibrate_stem_scales(
        params, base, jnp.asarray(_inputs(1)[0]), dtype=jnp.float32)
    cfg = _cnn_cfg("int8", scales)
    got, want = _logits(cfg, params, _inputs(), dtype)
    np.testing.assert_allclose(got, want, atol=2e-4 if dtype == "f32"
                               else 1e-3, rtol=0)


def test_int8_vit_model_logits_match_jax_apply():
    """The W8A8 ViT in f32, off the accelerator on the JAX side (its XLA
    attention), scales calibrated by the JAX package: the integer products
    are exact and the epilogues round alike, so only the attention's and
    the layer norms' f32 sums differ in order; atol 2e-5, rtol 1e-4, as
    the dense ViT's logits."""
    base = _vit_cfg()
    params = _params(base)
    scales = jax_vit_int8.calibrate_vit_scales(
        params, base, jnp.asarray(_inputs(1)[0]), dtype=jnp.float32)
    cfg = _vit_cfg("int8", scales)
    got, want = _logits(cfg, params, _inputs())
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------ refusals

def _port_cfg(**image):
    base = ModelConfig()
    return dataclasses.replace(base, image=dataclasses.replace(
        base.image, **image))


@pytest.mark.parametrize("image,train,match", [
    ({"encoder": "vit", "store_dtype": "f8e4m3"}, None, "CNN-stem serving"),
    ({"store_dtype": "int4"}, None, "expected 'compute', 'f8e4m3' or"),
    ({"encoder": "vit", "store_dtype": "int8", "moe_experts": 4}, None,
     "does not support MoE"),
    ({"store_dtype": "int8", "quant_scales": (1.0, 2.0, 3.0)}, True,
     "inference-only"),
    ({"encoder": "vit", "store_dtype": "int8"}, True, "inference-only"),
    ({"store_dtype": "int8"}, False, "needs calibrated activation scales"),
    ({"encoder": "vit", "store_dtype": "int8", "quant_scales": (1.0,) * 15},
     False, r"has 15 entries; the vit W8A8 mode needs 16"),
], ids=["vit_f8", "unknown", "vit_int8_moe", "cnn_int8_train",
        "vit_int8_train", "cnn_int8_unscaled", "vit_int8_scales"])
def test_quantized_modes_refuse_what_the_jax_model_refuses(image, train,
                                                           match):
    """Each a ``ValueError`` in the JAX model's words
    (``dl_vqa_tpu/models/vqa.py``)."""
    with pytest.raises(ValueError, match=match):
        _port_cfg(**image).check_ported(train=train)


@pytest.mark.parametrize("image", [
    {"store_dtype": "f8e4m3"}, {"store_dtype": "int8"},
    {"encoder": "vit", "store_dtype": "int8"}], ids=["f8", "int8", "vit_int8"])
def test_the_quantized_modes_build(image):
    """The three modes are ported: a model builds (int8 before its scales
    are calibrated), and f8 also trains (checked when a forward runs)."""
    cfg = _port_cfg(**image)
    cfg.check_ported()
    model = VqaNet(dataclasses.replace(cfg, max_answers=4, num_tokens=8),
                   device="cpu")
    assert model.image.quant.store_dtype == image["store_dtype"]
    if image["store_dtype"] == "f8e4m3":
        cfg.check_ported(train=True)
        cfg.check_ported(train=False)


def test_cnn_int8_stem_refuses_a_wrong_number_of_scales():
    x = torch.zeros(1, 20, 20, 3)
    image = _stem_params(0)
    with pytest.raises(ValueError, match="has 2 entries; the stem has 3"):
        conv_int8.int8_stem_forward(
            [_Conv(w, b) for w, b in image.values()], x, (1.0, 1.0), 1,
            torch.float32)


def test_int8_training_raises_in_the_forward():
    cfg = _cnn_cfg("int8", (1.0, 1.0, 1.0))
    model = _port(cfg, _params(_cnn_cfg()))
    images, questions, lengths = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="inference-only"):
        model(images, questions, lengths, train=True,
              generator=torch.Generator().manual_seed(0))


def test_configure_changes_the_serving_mode_only():
    model = VqaNet(ModelConfig.from_meta_dict(dataclasses.asdict(_cnn_cfg())),
                   device="cpu")
    f8 = dataclasses.replace(model.cfg, image=dataclasses.replace(
        model.cfg.image, store_dtype="f8e4m3"))
    model.configure(f8)
    assert model.cfg is f8 and model.image.quant.store_dtype == "f8e4m3"
    with pytest.raises(ValueError, match="store_dtype and"):
        model.configure(dataclasses.replace(f8, max_answers=31))
