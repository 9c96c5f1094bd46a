"""The port's ViT image encoder against ``dl_vqa_tpu.models.vit``, on the
CPU: the plain versions of the two attention kernels against the Pallas
kernels in interpret mode and against the JAX reference, the layer norm,
the patch embed, the weight bridge, the whole model (forward, gradients,
Adam steps, a served checkpoint).

Inputs come from a numpy seed and go to both sides. The JAX model runs its
accelerator path here: a stand-in for the ``jax`` name inside
``models/vit.py`` answers ``default_backend()`` with ``"tpu"``, so the
model takes the stride-P conv patch embed and dispatches the Pallas
attention kernels, which this file switches to interpret mode. Nothing in
the JAX package changes for that.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_vqa_tpu.models import transformer as jax_transformer
from dl_vqa_tpu.models import vit as jax_vit
from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig,
    ClassifierConfig,
    ImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig,
)
from dl_vqa_tpu.ops import vit_attention_pallas as jax_attention
from dl_vqa_tpu.ops.lstm import reverse_valid_prefix
from dl_vqa_tpu.ops.lstm_pallas import lstm_scan_pallas
from dl_vqa_tpu.train import state as jax_state
from dl_vqa_tpu.train import steps as jax_steps
from dl_vqa_tpu.utils.checkpoint import save_checkpoint
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.transformer import layer_norm
from dl_vqa_tpu_torch.models.vit import patch_embed
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_backward_cuda,
    vit_attention_backward_reference,
    vit_attention_cuda,
    vit_attention_reference,
)
from dl_vqa_tpu_torch.ops.vqa_metrics import soft_cross_entropy
from dl_vqa_tpu_torch.predict import Predictor
from dl_vqa_tpu_torch.train import create_train_state, make_train_step
from dl_vqa_tpu_torch.utils.params import (
    jax_params_from_model,
    jax_tree_from_named,
    load_jax_params,
    torch_state_from_params,
)

NUM_TOKENS, SEQ, ANSWERS = 30, 6, 40
LR = 1e-3
TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_torch_model.py::TOL
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------ the kernels

def _qkv(shape, name, seed=0, scale=1.0):
    """The same seeded values as a JAX and as a torch array of the dtype
    that ``name`` stands for."""
    jdt, tdt = DTYPES[name]
    values = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    as_torch = torch.from_numpy(values).to(tdt)
    return jnp.asarray(values).astype(jdt), as_torch


def _f32(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("batch,seq,heads", [(4, 196, 4), (2, 50, 2),
                                             (2, 257, 1), (1, 784, 1)])
def test_attention_plain_version_matches_the_pallas_kernel(batch, seq, heads,
                                                           name):
    """Same order of operations on the same inputs. f32: sums in another
    order, 1e-5 on outputs of order 1. bf16: the f32 result lies within
    1e-5 too, so the rounded outputs are equal except where that moves a
    value, or one of the weights e, across a rounding boundary: those
    differ by one bf16 step (2^-8 of the value, or of the largest outputs,
    1e-3, for a value near zero), and must be few (under 1 in 100)."""
    qkv_j, qkv_t = _qkv((batch, seq, 3 * heads * 64), name)
    expected = _f32(jax_attention._vit_attention_impl(qkv_j, heads,
                                                      interpret=True))
    got = _f32(vit_attention_reference(qkv_t, heads))
    assert got.shape == (batch, seq, heads * 64)
    if name == "f32":
        np.testing.assert_allclose(got, expected, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, expected, atol=1e-3, rtol=2 ** -7)
        assert (got != expected).mean() < 0.01


@pytest.mark.parametrize("batch,seq,heads", [(2, 196, 2), (2, 52, 2)])
def test_attention_plain_version_matches_the_jax_reference_f32(batch, seq,
                                                               heads):
    """The JAX reference normalises the weights, the kernel the output:
    2e-5 in f32, the JAX package's own tolerance between the two."""
    qkv_j, qkv_t = _qkv((batch, seq, 3 * heads * 64), "f32", seed=1)
    expected = _f32(jax_attention.vit_attention_qkv_reference(qkv_j, heads))
    np.testing.assert_allclose(_f32(vit_attention_reference(qkv_t, heads)),
                               expected, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_attention_backward_plain_version_matches_the_pallas_kernel(name):
    """An arbitrary cotangent at (2, 196, 2, 64). f32: 1e-5 absolute on
    gradients of order 1. bf16: two roundings lie on the way (w, dz), so a
    flipped w moves dz's inputs; outputs within 2 bf16 steps of each
    other (or of the largest gradients, 2e-3, near zero), and fewer than
    2 in 100 differ at all."""
    qkv_j, qkv_t = _qkv((2, 196, 3 * 2 * 64), name, seed=2)
    g_j, g_t = _qkv((2, 196, 2 * 64), name, seed=3)
    expected = _f32(jax_attention._vit_attention_bwd_impl(qkv_j, g_j, 2,
                                                          interpret=True))
    got = _f32(vit_attention_backward_reference(qkv_t, g_t, 2))
    assert got.shape == (2, 196, 3 * 2 * 64)
    if name == "f32":
        np.testing.assert_allclose(got, expected, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got, expected, atol=2e-3, rtol=2 ** -6)
        assert (got != expected).mean() < 0.02


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("batch,seq,heads,head", [
    (2, 257, 1, 64), (1, 784, 1, 64), (1, 257, 1, 128), (1, 784, 2, 128)])
def test_attention_plain_versions_match_the_pallas_kernels_past_256_tokens(
        batch, seq, heads, head, name):
    """Past 256 tokens (the 448-px ViT's 784 among them; the Pallas kernels
    take a chunk of whole sequences of any length), heads of 64 and 128,
    an arbitrary cotangent: the forward and the backward against the
    Pallas kernels in interpret mode, at the tolerances of the shorter
    sequences above (f32 1e-5; bf16 within one bf16 step forward and two
    backward, fewer than 1 and 2 in 100 off at all)."""
    qkv_j, qkv_t = _qkv((batch, seq, 3 * heads * head), name, seed=22)
    g_j, g_t = _qkv((batch, seq, heads * head), name, seed=23)
    out = _f32(vit_attention_reference(qkv_t, heads))
    want_out = _f32(jax_attention._vit_attention_impl(qkv_j, heads,
                                                      interpret=True))
    grad = _f32(vit_attention_backward_reference(qkv_t, g_t, heads))
    want_grad = _f32(jax_attention._vit_attention_bwd_impl(
        qkv_j, g_j, heads, interpret=True))
    assert out.shape == (batch, seq, heads * head)
    assert grad.shape == (batch, seq, 3 * heads * head)
    if name == "f32":
        np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=0)
        np.testing.assert_allclose(grad, want_grad, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(out, want_out, atol=1e-3, rtol=2 ** -7)
        assert (out != want_out).mean() < 0.01
        np.testing.assert_allclose(grad, want_grad, atol=2e-3, rtol=2 ** -6)
        assert (grad != want_grad).mean() < 0.02


def test_attention_backward_plain_version_matches_jax_vjp_f32():
    """Against ``jax.vjp`` of the JAX reference, at the 1e-4 of the JAX
    package's own test of its backward kernel."""
    qkv_j, qkv_t = _qkv((2, 196, 3 * 2 * 64), "f32", seed=4)
    g_j, g_t = _qkv((2, 196, 2 * 64), "f32", seed=5)
    _, vjp = jax.vjp(
        lambda t: jax_attention.vit_attention_qkv_reference(t, 2), qkv_j)
    np.testing.assert_allclose(
        _f32(vit_attention_backward_reference(qkv_t, g_t, 2)),
        _f32(vjp(g_j)[0]), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_autograd_through_the_function_gives_the_plain_backward(name):
    """On the CPU the Function runs both plain versions: ``dqkv`` to the
    bit, also for a cotangent that arrives non-contiguous."""
    _, qkv = _qkv((2, 50, 3 * 2 * 64), name, seed=6)
    _, g = _qkv((2, 50, 2 * 64), name, seed=7)
    leaf = qkv.clone().requires_grad_(True)
    out = vit_attention(leaf, 2)
    assert torch.equal(out, vit_attention_reference(qkv, 2))
    out.backward(g)
    expected = vit_attention_backward_reference(qkv, g, 2)
    assert torch.equal(leaf.grad, expected)
    leaf.grad = None
    vit_attention(leaf, 2).transpose(0, 1).backward(g.transpose(0, 1))
    assert torch.equal(leaf.grad, expected)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_attention_heads_are_not_mixed(which):
    """Zeroing head 1's q, k and v lanes leaves head 0's outputs (and its
    gradients) equal to the bit."""
    _, qkv = _qkv((2, 52, 3 * 2 * 64), "f32", seed=8)
    _, g = _qkv((2, 52, 2 * 64), "f32", seed=9)
    zeroed = qkv.clone()
    for part in range(3):
        zeroed[..., part * 128 + 64:part * 128 + 128] = 0
    if which == "forward":
        a, b = (vit_attention_reference(t, 2) for t in (qkv, zeroed))
        assert torch.equal(a[..., :64], b[..., :64])
        assert not torch.equal(a[..., 64:], b[..., 64:])
    else:
        a, b = (vit_attention_backward_reference(t, g, 2)
                for t in (qkv, zeroed))
        for part in range(3):
            lanes = slice(part * 128, part * 128 + 64)
            assert torch.equal(a[..., lanes], b[..., lanes])


@pytest.mark.parametrize("call", [
    lambda: vit_attention_cuda(torch.zeros(1, 4, 3 * 64), 1),
    lambda: vit_attention_backward_cuda(torch.zeros(1, 4, 3 * 64),
                                        torch.zeros(1, 4, 64), 1),
    lambda: vit_attention_cuda(torch.zeros(1, 4, 3 * 32, device="meta"), 1),
    lambda: vit_attention_cuda(torch.zeros(4, 3 * 64), 1),
    lambda: vit_attention_reference(torch.zeros(1, 4, 100), 3),
], ids=["cpu_forward", "cpu_backward", "head_of_32", "two_dims",
        "not_3hd"])
def test_attention_wrappers_raise_on_what_they_do_not_take(call):
    """A ``*_cuda`` wrapper never gives way to the plain version."""
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_attention_plain_versions_match_the_pallas_kernels_at_heads_of_128(
        name):
    """Two heads of 128 (the kernels walk such a head in two slices of
    64), S = 52, an arbitrary cotangent: the forward and the backward
    against the Pallas kernels in interpret mode, at the head-64 tests'
    tolerances (f32 1e-5; bf16 within one bf16 step forward and two
    backward, fewer than 1 and 2 in 100 off at all)."""
    qkv_j, qkv_t = _qkv((2, 52, 3 * 2 * 128), name, seed=20)
    g_j, g_t = _qkv((2, 52, 2 * 128), name, seed=21)
    out = _f32(vit_attention_reference(qkv_t, 2))
    want_out = _f32(jax_attention._vit_attention_impl(qkv_j, 2,
                                                      interpret=True))
    grad = _f32(vit_attention_backward_reference(qkv_t, g_t, 2))
    want_grad = _f32(jax_attention._vit_attention_bwd_impl(qkv_j, g_j, 2,
                                                           interpret=True))
    assert out.shape == (2, 52, 256) and grad.shape == (2, 52, 768)
    if name == "f32":
        np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=0)
        np.testing.assert_allclose(grad, want_grad, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(out, want_out, atol=1e-3, rtol=2 ** -7)
        assert (out != want_out).mean() < 0.01
        np.testing.assert_allclose(grad, want_grad, atol=2e-3, rtol=2 ** -6)
        assert (grad != want_grad).mean() < 0.02


# ------------------------------------------------------- the model's pieces

@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_layer_norm_matches_jax(name):
    """f32 statistics on both sides: 1e-6 in f32 on values of order 1; in
    bf16 equal except for one-step flips."""
    x_j, x_t = _qkv((3, 7, 128), name, seed=10, scale=2.0)
    rng = np.random.default_rng(11)
    scale, bias = (rng.standard_normal(128).astype(np.float32)
                   for _ in range(2))
    expected = _f32(jax_transformer._layer_norm(x_j, jnp.asarray(scale),
                                                jnp.asarray(bias)))
    got = layer_norm(x_t, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == x_t.dtype
    if name == "f32":
        np.testing.assert_allclose(_f32(got), expected, atol=2e-6, rtol=1e-6)
    else:
        np.testing.assert_allclose(_f32(got), expected, atol=0, rtol=2 ** -7)
        assert (_f32(got) != expected).mean() < 0.01


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_patch_embed_matches_the_jax_conv_path(name):
    """The stride-P conv rounds its f32 accumulator to the compute dtype
    before the f32 bias add. f32: 1e-5 (sums of 768 products in another
    order). bf16: the same rounded product, so equal but for one-step
    flips of that rounding (2^-8 of values of order 1)."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(12)
    images = rng.standard_normal((2, 48, 32, 3)).astype(np.float32)
    w = (rng.standard_normal((768, 128)) / 28).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    expected = np.asarray(jax_vit._patch_embed_conv(
        jnp.asarray(images).astype(jdt), {"w": jnp.asarray(w),
                                           "b": jnp.asarray(b)}, 16, jdt))
    got = patch_embed(torch.from_numpy(images), torch.from_numpy(w.T.copy()),
                      torch.from_numpy(b), 16, tdt)
    assert got.shape == (2, 6, 128) and got.dtype == torch.float32
    assert expected.dtype == np.float32
    if name == "f32":
        np.testing.assert_allclose(got.numpy(), expected, atol=1e-5, rtol=0)
        matmul = np.asarray(jax_vit._patch_embed_matmul(
            jnp.asarray(images), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
            16, jnp.float32))
        np.testing.assert_allclose(got.numpy(), matmul, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), expected, atol=2 ** -6,
                                   rtol=0)
        assert (got.numpy() != expected).mean() < 0.01


# ------------------------------------------------------------ the bridge

def _jax_cfg(layers=2, dropout=0.0, image_size=32, moe=0):
    return JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=dropout),
        image=ImageConfig(encoder="vit", num_channels=(3, 128),
                          patch_size=16, num_layers=layers, num_heads=2,
                          dropout=dropout, moe_experts=moe),
        attention=AttentionConfig(hidden_dim=12, glimpses=2,
                                  dropout=dropout),
        classifier=ClassifierConfig(hidden_dim=20, dropout=dropout),
        max_answers=ANSWERS, image_size=image_size, num_tokens=NUM_TOKENS)


def _port_cfg(jax_cfg):
    return ModelConfig.from_meta_dict(dataclasses.asdict(jax_cfg))


def _params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(seed), cfg))


def _model(cfg, params):
    return load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), params)


def _flat(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_bridge_round_trips_the_vit_tree_to_the_bit():
    cfg = _jax_cfg(layers=3)
    params = _params(cfg)
    # Make the layer-norm leaves and the layers differ from each other.
    rng = np.random.default_rng(13)
    params = jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.01).astype(np.float32),
        params)
    assert params["image"]["layers"]["qkv"]["w"].shape == (3, 128, 384)
    state = torch_state_from_params(params)
    assert state["image.blocks.2.qkv.weight"].shape == (384, 128)
    assert state["image.patch_embed.weight"].shape == (128, 768)
    np.testing.assert_array_equal(state["image.blocks.1.ln2.weight"],
                                  params["image"]["layers"]["ln2"]["scale"][1])
    model = _model(cfg, params)
    assert sorted(model.state_dict()) == sorted(state)
    back, want = _flat(jax_params_from_model(model)), _flat(params)
    assert back.keys() == want.keys()
    for name, value in want.items():
        assert back[name].dtype == np.float32, name
        np.testing.assert_array_equal(back[name], value, err_msg=name)


@pytest.mark.parametrize("tree", ["moe", "transformer_text", "stacked"])
def test_bridge_refuses_the_trees_it_does_not_map(tree):
    """The transformer text and stacked trees are mapped
    (``tests/test_torch_variants.py``), so those cases are malformed trees:
    a text tree that is neither the LSTM's nor the transformer's, a stacked
    attention tree without its projections. Each raises naming what it
    lacks. MoE blocks are mapped now: that case is the bridge's round trip
    of a MoE tree, to the bit."""
    if tree == "moe":
        # The jitted init: the eager one of the expert tensors takes seconds.
        params = jax.tree_util.tree_map(np.asarray, jax.jit(
            vqa.init, static_argnums=(1,))(jax.random.PRNGKey(0),
                                           _jax_cfg(moe=4)))
        assert "moe" in params["image"]["layers"]
        model = _model(_jax_cfg(moe=4), params)
        back, want = _flat(jax_params_from_model(model)), _flat(params)
        assert back.keys() == want.keys()
        assert any("['moe']['gate']" in name for name in want)
        for name, value in want.items():
            np.testing.assert_array_equal(back[name], value, err_msg=name)
        return
    params = _params(_jax_cfg())
    if tree == "transformer_text":
        params["text"] = {"embedding": params["text"]["embedding"]}
        match = "text.lstm_fwd"
    else:
        params["attention"] = {"layers": []}
        match = "attention.v_conv"
    with pytest.raises(ValueError, match=match):
        torch_state_from_params(params)


# ------------------------------------------------------------ the model

class _JaxOnTpu:
    """Stands in for the ``jax`` name inside ``models/vit.py``: everything
    is JAX's own, except that the backend reads as a TPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture
def tpu_path(monkeypatch):
    """The JAX model on its accelerator path: conv patch embed, the Pallas
    attention kernels (interpret mode), and for bf16 the Pallas LSTM."""
    forward = jax_attention.vit_attention_qkv_pallas
    fused = jax_attention.vit_attention_qkv_pallas_fused_bwd
    monkeypatch.setattr(jax_vit, "jax", _JaxOnTpu())
    monkeypatch.setattr(jax_attention, "vit_attention_qkv_pallas",
                        lambda qkv, heads: forward(qkv, heads, True))
    monkeypatch.setattr(jax_attention, "vit_attention_qkv_pallas_fused_bwd",
                        lambda qkv, heads: fused(qkv, heads, True))

    def bilstm(x, lengths, fwd_params, bwd_params, use_pallas=False):
        _, c_fwd = lstm_scan_pallas(x, lengths, fwd_params, interpret=True)
        _, c_bwd = lstm_scan_pallas(reverse_valid_prefix(x, lengths), lengths,
                                    bwd_params, interpret=True)
        return jnp.concatenate([c_fwd, c_bwd], axis=-1)

    return lambda: monkeypatch.setattr(vqa, "bilstm_final_cell", bilstm)


def _inputs(image_size, uint8, seed=0, batch=3):
    rng = np.random.default_rng(seed)
    if uint8:
        images = rng.integers(0, 256, (batch, image_size, image_size, 3),
                              dtype=np.uint8)
    else:
        images = rng.standard_normal(
            (batch, image_size, image_size, 3)).astype(np.float32)
    lengths = np.array([SEQ, 1, 4, 2][:batch], dtype=np.int32)
    questions = rng.integers(1, NUM_TOKENS, (batch, SEQ)).astype(np.int32)
    questions *= np.arange(SEQ)[None, :] < lengths[:, None]
    return images, questions, lengths


def _logits(cfg, inputs, name):
    jdt, tdt = DTYPES[name]
    params = _params(cfg)
    expected = np.asarray(vqa.apply(
        params, cfg, *(jnp.asarray(a) for a in inputs), train=False,
        compute_dtype=jdt))
    with torch.no_grad():
        got = _model(cfg, params)(*(torch.from_numpy(a) for a in inputs),
                                  compute_dtype=tdt)
    return got.numpy(), expected


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("path", ["cpu_path", "tpu_path"])
def test_vit_logits_match_jax_apply_f32(request, path, uint8):
    """In f32 both branches of the JAX model (matmul patch embed and plain
    attention off the accelerator; conv and kernel on it) agree with the
    port. 64 px: a 4 x 4 grid, 16 tokens."""
    if path == "tpu_path":
        request.getfixturevalue("tpu_path")
    cfg = _jax_cfg(image_size=64)
    got, expected = _logits(cfg, _inputs(64, uint8), "f32")
    assert got.shape == (3, ANSWERS) and got.dtype == np.float32
    np.testing.assert_allclose(got, expected, **TOL)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_vit_bf16_logits_match_the_jax_accelerator_path(tpu_path, uint8,
                                                        seed):
    """bf16, as ``config_vit`` serves: every rounding of the JAX model's
    accelerator path is where the port rounds, so most logits are equal to
    the bit. The two frameworks' exp and rsqrt differ in the last place,
    which now and then moves one bf16 rounding of an activation by a step
    (2^-8 of it); through this 128-wide model that moves one sample's
    logits by up to 1e-4 (seen: none at every second seed, at most 8.6e-5
    over eight seeds). So: the median difference at most 1e-6 and the
    largest at most 2e-4. Off that path the JAX model rounds the softmax
    weights instead of the output and keeps f32 through the patch embed's
    bias: there the median is 2e-5 to 6e-5 and the largest 1.2e-4 to
    3.1e-4."""
    tpu_path()
    cfg = _jax_cfg(image_size=64)
    got, expected = _logits(cfg, _inputs(64, uint8, seed=seed), "bf16")
    assert np.median(np.abs(got - expected)) <= 1e-6
    np.testing.assert_allclose(got, expected, atol=2e-4, rtol=0)


def _heads_cfg(heads):
    """``_jax_cfg`` at width 256 (64 px, 16 tokens) with ``heads`` heads."""
    cfg = _jax_cfg(image_size=64)
    return dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, num_channels=(3, 256), num_heads=heads))


@pytest.mark.parametrize("heads", [2, 8], ids=["heads_of_128",
                                               "heads_of_32"])
def test_vit_logits_at_other_heads_match_the_jax_accelerator_path(
        tpu_path, heads):
    """Width 256, f32. Two heads of 128: the JAX model runs its Pallas
    kernels (interpret mode), the port kernels 4 and 5's plain versions.
    Eight heads of 32: the JAX model takes its other branch, which
    normalises the weights in the compute dtype, and so does the port on
    every device. ``TOL``. (bf16 is held at the attention core below: at
    this width the two frameworks' bf16 roundings elsewhere in the model
    move every logit by up to 2e-4, whatever the heads.)"""
    tpu_path()
    got, expected = _logits(_heads_cfg(heads), _inputs(64, True, seed=4),
                            "f32")
    np.testing.assert_allclose(got, expected, **TOL)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_heads_of_32_take_the_jax_models_other_branch(tpu_path, name):
    """Eight heads of 32, the attention core of a block against the JAX
    model's ``_attention`` on its accelerator path (which takes its other
    branch at such heads), with projections that only permute the lanes
    (exact in both packages), so that the core is compared alone. The port
    now matches it: f32 within 1e-6 (sums in another order), bf16 to the
    bit. The fault this repairs: the port ran the kernels' arithmetic (the
    output normalised, not the weights) for every head; in bf16 that was
    off by roundings (half a percent of the largest output here, in most
    elements), in f32 only by the order of sums."""
    from dl_vqa_tpu_torch.models.vit import VitBlock

    tpu_path()
    jdt, tdt = DTYPES[name]
    dim, heads = 256, 8
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 16, dim)).astype(np.float32)
    eye = np.eye(dim, dtype=np.float32)
    w = np.concatenate([eye, np.roll(eye, 1, axis=1),
                        np.roll(eye, 7, axis=1)], axis=1)
    layer = {"qkv": {"w": jnp.asarray(w), "b": jnp.zeros(3 * dim)},
             "out": {"w": jnp.asarray(eye), "b": jnp.zeros(dim)}}
    expected = _f32(jax_vit._attention(jnp.asarray(x).astype(jdt), layer,
                                       heads, jdt, use_pallas=True))
    qkv = torch.from_numpy(x @ w).to(tdt)
    new = _f32(VitBlock(dim, heads, 0.0).attention(qkv, plain=False))
    old = _f32(vit_attention_reference(qkv, heads))
    if name == "f32":
        np.testing.assert_allclose(new, expected, atol=1e-6, rtol=0)
        np.testing.assert_allclose(old, expected, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(new, expected)
        assert (old != expected).mean() > 0.2
        assert np.abs(old - expected).max() > 2 ** -9 * np.abs(expected).max()


def test_image_larger_than_the_position_table_raises_and_a_ragged_one_is_cropped():
    cfg = _jax_cfg()
    model = VqaNet(_port_cfg(cfg), device="cpu")
    images, questions, lengths = (torch.from_numpy(a)
                                  for a in _inputs(32, False))
    with torch.no_grad():
        exact = model(images, questions, lengths)
        ragged = model(torch.nn.functional.pad(images, (0, 0, 0, 5, 0, 9)),
                       questions, lengths)
        assert torch.equal(exact, ragged)
        with pytest.raises(ValueError, match="positional table"):
            model(torch.zeros(3, 48, 48, 3), questions, lengths)


# ------------------------------------------------------------ training

def _batch(seed, image_size=32, batch=8):
    rng = np.random.default_rng(seed)
    images, questions, lengths = _inputs(image_size, False, seed, batch=4)
    images = np.concatenate([images, images[::-1] * 0.5])[:batch]
    return {
        "images": images,
        "questions": np.concatenate([questions, questions[::-1]])[:batch],
        "lengths": np.concatenate([lengths, lengths[::-1]])[:batch],
        "answer_indices": rng.integers(
            0, ANSWERS + 1, (batch, 10)).astype(np.int32),
        "answer_values": rng.integers(0, 11, (batch, 10)).astype(np.int32),
        "mask": np.array([1, 1, 1, 0, 1, 1, 1, 1][:batch], dtype=bool),
    }


def _assert_trees_close(got, expected, atol, rtol, what):
    got, expected = _flat(got), _flat(expected)
    assert got.keys() == expected.keys()
    for name, value in expected.items():
        np.testing.assert_allclose(got[name], np.asarray(value), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {name}")


def test_vit_gradients_at_step_0_match_jax_grad(tpu_path):
    """Per tensor under the JAX names, stacked layers included, against
    the JAX model with its flash backward kernel (interpret mode). f32
    sums in another order through two blocks, an LSTM and two softmaxes:
    atol 2e-6, rtol 1e-4, as the CNN model's gradients."""
    cfg = _jax_cfg()
    params, batch = _params(cfg), _batch(1)

    def loss_fn(p):
        return jax_steps._forward_loss(
            p, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, True,
            jax.random.PRNGKey(0), jnp.float32)[0]

    expected_loss, expected = jax.value_and_grad(loss_fn)(params)
    model = _model(cfg, params)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tensors["images"], tensors["questions"],
                   tensors["lengths"], train=True,
                   generator=torch.Generator().manual_seed(0))
    loss = soft_cross_entropy(logits, tensors["answer_indices"],
                              tensors["answer_values"], tensors["mask"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(expected_loss),
                               rtol=1e-5)
    got = jax_tree_from_named({n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None})
    _assert_trees_close(got, expected, 2e-6, 1e-4, "gradient of")
    assert np.abs(got["image"]["layers"]["qkv"]["w"]).max() > 1e-4
    assert np.abs(got["image"]["pos"]).max() > 1e-4


def _jax_cfg_448():
    """One block, one head of 64, patch 16 at 448 px: a 28 x 28 grid, the
    784 tokens of ``config_vit`` at ``train.image_size=448``."""
    return dataclasses.replace(
        _jax_cfg(layers=1, image_size=448),
        image=ImageConfig(encoder="vit", num_channels=(3, 64), patch_size=16,
                          num_layers=1, num_heads=1, dropout=0.0))


@pytest.mark.parametrize("path", ["cpu_path", "tpu_path"])
def test_vit_logits_at_448_px_match_jax_apply_f32(request, path):
    """784 tokens, past the 256 that kernels 4 and 5 keep a score row of in
    registers: the port's logits against both branches of the JAX model
    (the Pallas kernels in interpret mode on its accelerator path), at
    the 64-px test's tolerance."""
    if path == "tpu_path":
        request.getfixturevalue("tpu_path")
    cfg = _jax_cfg_448()
    got, expected = _logits(cfg, _inputs(448, False, batch=2), "f32")
    assert got.shape == (2, ANSWERS)
    np.testing.assert_allclose(got, expected, **TOL)


def test_vit_gradients_at_448_px_match_jax_grad(tpu_path):
    """784 tokens: the gradient of every tensor against the JAX model with
    its flash backward kernel (interpret mode), at the 32-px test's atol
    2e-6, rtol 1e-4, the position table's 784 rows among them."""
    cfg = _jax_cfg_448()
    params = _params(cfg)
    batch = _batch(1, image_size=448, batch=4)

    def loss_fn(p):
        return jax_steps._forward_loss(
            p, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, True,
            jax.random.PRNGKey(0), jnp.float32)[0]

    expected_loss, expected = jax.value_and_grad(loss_fn)(params)
    model = _model(cfg, params)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tensors["images"], tensors["questions"],
                   tensors["lengths"], train=True,
                   generator=torch.Generator().manual_seed(0))
    loss = soft_cross_entropy(logits, tensors["answer_indices"],
                              tensors["answer_values"], tensors["mask"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(expected_loss),
                               rtol=1e-5)
    got = jax_tree_from_named({n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None})
    _assert_trees_close(got, expected, 2e-6, 1e-4, "gradient of")
    assert got["image"]["pos"].shape == (784, 64)
    assert np.abs(got["image"]["pos"]).max() > 1e-6


def test_vit_20_adam_steps_match_the_jax_train_step(tpu_path):
    """Two batches in turn for 20 steps, f32, dropout 0, against the jitted
    JAX step (conv patch embed, flash backward kernel in interpret mode).
    Per-step loss within 1e-4 relative; parameter deltas (each at most 20
    * LR) within 5e-4 absolute wherever the JAX run's own second moment
    says the gradient is clear of rounding noise (root mean square above
    1e-6), and within Adam's bound of LR a step everywhere: the tolerances
    and their reasons are those of the CNN model's 50-step test."""
    cfg = _jax_cfg()
    params = _params(cfg)
    batches = [_batch(10 + i % 2) for i in range(20)]
    tx = jax_steps.make_optimizer(LR)
    jax_train = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    jax_step = jax_steps.make_train_step(cfg, tx, compute_dtype=jnp.float32,
                                         jit=True)
    state = create_train_state(_model(cfg, params), LR, device="cpu")
    step = make_train_step(_port_cfg(cfg), compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    losses, jax_losses = [], []
    for batch in batches:
        jax_train, jax_metrics = jax_step(
            jax_train, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
        state, metrics = step(state, batch, gen)
        jax_losses.append(float(jax_metrics["loss"]))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert losses[18] < losses[0] and state.step == 20
    got = _flat(jax_params_from_model(state.model))
    want = _flat(jax_train.params)
    start = _flat(params)
    second_moment = _flat(jax_train.opt_state[0].nu)
    compared = total = 0
    for name in want:
        delta = got[name] - start[name]
        expected = np.asarray(want[name]) - start[name]
        rms = np.sqrt(np.asarray(second_moment[name]) / (1.0 - 0.999 ** 20))
        clear = rms > 1e-6
        compared += int(clear.sum())
        total += clear.size
        np.testing.assert_allclose(delta[clear], expected[clear], atol=5e-4,
                                   rtol=0, err_msg=f"20-step delta of {name}")
        np.testing.assert_allclose(delta, expected, atol=2 * 20 * LR, rtol=0,
                                   err_msg=f"20-step delta of {name}")
    assert compared > 0.9 * total
    for name in ("['image']['pos']", "['image']['layers']['ln1']['scale']",
                 "['image']['final_ln']['bias']"):
        assert np.abs(np.asarray(want[name]) - start[name]).max() > 5 * LR


def test_vit_train_mode_draws_two_sites_a_block_more_than_the_cnn():
    """With dropout 0.3 everywhere the ViT forward draws at 1 + 2 L image
    sites (after the position add, and after the attention and the MLP of
    each block) where the CNN draws at one, so at 7 + 2 L sites in all
    against the CNN model's 7. The same seed gives the same logits,
    another seed other logits."""
    layers = 2
    cfg = _port_cfg(_jax_cfg(layers=layers, dropout=0.3))
    model = VqaNet(cfg, device="cpu")
    images, questions, lengths = (torch.from_numpy(a)
                                  for a in _inputs(32, False))
    calls = []
    randint = torch.randint

    def counting(*args, **kwargs):
        calls.append(args[2])
        return randint(*args, **kwargs)

    def run(seed):
        return model(images, questions, lengths, train=True,
                     generator=torch.Generator().manual_seed(seed))

    torch.randint = counting
    try:
        a = run(1)
    finally:
        torch.randint = randint
    cnn_sites = 7
    assert len(calls) == cnn_sites - 1 + 1 + 2 * layers
    # The image encoder's sites come first, in the forward's order.
    assert [tuple(s) for s in calls[:1 + 2 * layers]] == [(3, 4, 128)] * 5
    assert torch.equal(a, run(1)) and not torch.equal(a, run(2))
    a.sum().backward()
    assert all(p.grad is not None for p in model.parameters()
               if p.requires_grad)


# ------------------------------------------------------------ serving

def test_predictor_serves_a_jax_vit_checkpoint(tmp_path):
    """An npz checkpoint the JAX package wrote for a small ViT model, with
    its ``model_cfg`` metadata: same logits (f32 tolerance), same top-1,
    probabilities within 1e-5."""
    cfg = _jax_cfg(image_size=64)
    params = vqa.init(jax.random.PRNGKey(5), cfg)
    path = str(tmp_path / "vit.npz")
    save_checkpoint(path, {"params": params, "step": jnp.zeros(())}, epoch=1,
                    model_cfg=cfg, extra_meta={"max_question_length": SEQ})
    words = ["what", "color", "is", "the", "dog", "how", "many"]
    vocab = {"question": {w: i + 1 for i, w in enumerate(words)},
             "answer": {f"a{i}": i + 1 for i in range(ANSWERS)}}
    vocab_path = str(tmp_path / "vocab.json")
    with open(vocab_path, "w") as fd:
        json.dump(vocab, fd)
    predictor = Predictor.from_checkpoint(path, vocab_path, device="cpu",
                                          compute_dtype=torch.float32)
    assert predictor.model_cfg.image.encoder == "vit"
    assert dataclasses.asdict(predictor.model_cfg) == dataclasses.asdict(cfg)
    images = np.random.default_rng(6).integers(
        0, 256, (3, 64, 64, 3), dtype=np.uint8)
    questions = ["what color is the dog", "how many", "zebra"]
    encoded, lengths = predictor.encode_questions(questions)
    expected = np.asarray(vqa.apply(
        params, cfg, jnp.asarray(images), jnp.asarray(encoded),
        jnp.asarray(lengths)))
    np.testing.assert_allclose(
        predictor.forward_logits(images, encoded, lengths), expected, **TOL)
    expected_probs = np.asarray(jax.nn.softmax(expected, axis=-1))
    answers = predictor.predict(images, questions, top_k=2)
    for row, top in zip(expected_probs, answers):
        assert top[0][0] == f"a{int(row.argmax())}"
        assert abs(top[0][1] - float(row.max())) < 1e-5


# ------------------------------------------------------ the legacy layout

def _legacy_npz(path, tree):
    """``tree`` written as the JAX package wrote a ViT model before its
    blocks were stacked: each ``image|layers`` leaf of ``[L, ...]`` as L
    leaves under ``image|layers|#i|...``."""
    from dl_vqa_tpu.utils.checkpoint import _SEP, _flatten

    marker = f"image{_SEP}layers{_SEP}"
    legacy = {}
    for key, value in _flatten(tree).items():
        if marker in key:
            head, rest = key.split(marker, 1)
            for i in range(value.shape[0]):
                key = f"{head}{marker}#{i}{_SEP}{rest}"
                legacy[key] = np.asarray(value[i])
        else:
            legacy[key] = np.asarray(value)
    np.savez(path, **legacy)
    return path + ".npz"


@pytest.mark.parametrize("layers", [1, 2])
def test_a_legacy_list_of_layers_checkpoint_loads_as_jax_migrates_it(
        tmp_path, layers):
    """A ViT npz with the block stack as a list of per-layer dicts (keys
    ``params|image|layers|#i|...``): the JAX reader stacks it into its
    template; the port's reader hands the bridge a list, which the bridge
    stacks (it raised ``TypeError: unhashable type: 'dict'`` before). The
    port's state equals the state of the JAX-migrated tree to the bit, and
    its f32 logits match the JAX model's at the ViT parity tolerance."""
    from dl_vqa_tpu.utils import checkpoint as jax_ckpt
    from dl_vqa_tpu_torch.utils import checkpoint as port_ckpt

    cfg = _jax_cfg(layers=layers, image_size=64)
    params = _params(cfg, seed=layers)
    rng = np.random.default_rng(layers)  # the layers differ from each other
    params = jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.01).astype(np.float32),
        params)
    path = _legacy_npz(str(tmp_path / "legacy"), {"params": params})
    migrated = jax_ckpt.load_params(path, params_template=params)
    tree = port_ckpt.load_params(path)
    assert isinstance(tree["image"]["layers"], list)
    assert len(tree["image"]["layers"]) == layers
    got, want = torch_state_from_params(tree), torch_state_from_params(
        jax.tree_util.tree_map(np.asarray, migrated))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    inputs = _inputs(64, uint8=True)
    expected = np.asarray(vqa.apply(
        migrated, cfg, *(jnp.asarray(a) for a in inputs), train=False,
        compute_dtype=jnp.float32))
    with torch.no_grad():
        logits = _model(cfg, tree)(*(torch.from_numpy(a) for a in inputs),
                                   compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), expected, **TOL)


@pytest.mark.parametrize("layout", ["mixed_keys", "not_dicts", "empty",
                                    "array"])
def test_a_malformed_layers_layout_raises_naming_it(layout):
    """``image.layers`` that is neither stacked leaves nor a list of
    per-layer dicts of one structure raises ``ValueError`` naming what it
    found."""
    params = _params(_jax_cfg(layers=2))
    stacked = params["image"]["layers"]
    per_layer = [jax.tree_util.tree_map(lambda x: x[i], stacked)
                 for i in range(2)]
    if layout == "mixed_keys":
        del per_layer[1]["ln2"]
        layers, match = per_layer, "one structure"
    elif layout == "not_dicts":
        layers, match = [per_layer[0], np.zeros(3)], "dict, ndarray"
    elif layout == "empty":
        layers, match = [], "0 items"
    else:
        layers, match = np.zeros((2, 3)), "image.layers is a ndarray"
    params["image"]["layers"] = layers
    with pytest.raises(ValueError, match=match):
        torch_state_from_params(params)
