"""The port's fused ops against the JAX package's fused kernels, on the CPU.

Kernels 6 to 9 of the port replace four Pallas kernels that no entry point
of the JAX package dispatches: the tap-GEMM conv + ReLU + pool block and
the 4-phase stem of ``dl_vqa_tpu/ops/conv_fused.py``, the fused LN + MLP
block of ``experiments/probe_vit_mlp_fused.py`` and the layout cases of
``experiments/probe_mosaic_recheck.py``. The same inputs, made with numpy
from a seed, go through the Pallas kernel in interpret mode (as
``tests/test_pallas.py`` runs it) and through the port's dispatch, which
runs the plain PyTorch version for a CPU tensor. Then the slice as a
whole: ``VqaNet(...)(..., fused_ops=True)`` against ``fused_ops=False``
and against the JAX ``vqa.apply``, with the weights carried over from JAX
parameters. The fused blocks are the custom ops ``vqa::conv_relu_pool_fused``,
``vqa::conv_relu_pool_stem`` and ``vqa::fused_ln_mlp``; which of them a
forward dispatched is read by a dispatch mode (:class:`_FusedOps`), and
which plain versions ``plain_ops=True`` ran, by hooking them.

Tolerances: f32 atol = rtol = 1e-5 (f32 sums taken in another order);
bf16 one rounding of the output, 2^-7 relative; the layout cases to the
bit; gradients atol = rtol = 1e-4 as the JAX test of the same kernel.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig,
    ClassifierConfig,
    ImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig,
)
from dl_vqa_tpu.ops import conv_fused as jax_conv
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.ops import conv_fused as port_conv
from dl_vqa_tpu_torch.ops import layout_cases as port_layout
from dl_vqa_tpu_torch.ops import vit_mlp_fused as port_mlp
from dl_vqa_tpu_torch.train import (
    create_train_state, make_eval_step, make_train_step)
from dl_vqa_tpu_torch.utils.params import load_jax_params

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_STEP = 2.0 ** -7
FUSED_OPS = ("conv_relu_pool_stem", "conv_relu_pool_fused", "fused_ln_mlp")


class _FusedOps(TorchDispatchMode):
    """Records, in order, each fused block's op that runs under it, as
    ``vqa::<name>``."""

    def __init__(self, ran):
        super().__init__()
        self.ran = ran

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "vqa" and func._opname in FUSED_OPS:
            self.ran.append(f"vqa::{func._opname}")
        return func(*args, **(kwargs or {}))


def _hook_plain_versions(monkeypatch, ran):
    """Each fused block's plain version, as ``plain_ops=True`` calls it,
    appends its name to ``ran``."""
    for module, name in ((port_conv, "conv_relu_pool_fused_reference"),
                         (port_conv, "conv_relu_pool_stem_reference"),
                         (port_mlp, "fused_ln_mlp_reference")):
        plain = getattr(module, name)
        monkeypatch.setattr(
            module, name,
            lambda *args, plain=plain, name=name: ran.append(name)
            or plain(*args))


def _conv_inputs(h, cin, cout, k, seed=0, batch=2):
    """``(x, w, b)`` as numpy, ``w`` in the JAX layout ``[k, k, Cin, Cout]``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _torch_conv_args(x, w, b, dtype=torch.float32):
    """The port's arguments: NHWC ``x`` in ``dtype``, torch-layout weight
    ``[Cout, Cin, k, k]`` and the bias, both f32 masters."""
    return (torch.from_numpy(x).to(dtype),
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(b))


def _assert_within_one_bf16_rounding(got, expected):
    got, expected = np.asarray(got, np.float32), np.asarray(expected,
                                                            np.float32)
    limit = BF16_STEP * np.maximum(np.abs(expected), 1e-3)
    assert np.all(np.abs(got - expected) <= limit), float(
        np.max(np.abs(got - expected) / limit))


# ------------------------------------------------- kernel 6: the fused block

@pytest.mark.parametrize("h,cin,cout,k", [
    (64, 3, 8, 3), (37, 16, 32, 3), (24, 8, 16, 5), (20, 32, 8, 3)])
def test_fused_block_plain_version_matches_the_pallas_kernel(h, cin, cout, k):
    """The four shapes of ``test_conv_relu_pool_matches_reference``."""
    x, w, b = _conv_inputs(h, cin, cout, k)
    expected = jax_conv.conv_relu_pool_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    got = port_conv.conv_relu_pool_fused_reference(*_torch_conv_args(x, w, b))
    assert got.shape == expected.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


def test_fused_block_plain_version_matches_the_pallas_kernel_in_bf16():
    """bf16: both round the f32 accumulator once, after the pool; sums in
    another order can move that rounding by one step."""
    x, w, b = _conv_inputs(37, 16, 32, 3, seed=1)
    expected = jax_conv.conv_relu_pool_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
        interpret=True)
    got = port_conv.conv_relu_pool_fused_reference(
        *_torch_conv_args(x, w, b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_within_one_bf16_rounding(got.float().numpy(),
                                     expected.astype(jnp.float32))


def test_fused_block_rounds_once_where_the_unfused_block_rounds_twice():
    """The unfused block rounds the conv output to bf16 before the bias;
    the fused one does not. Equal in f32; in bf16 apart by that rounding,
    which is a step of the conv output and so, after the bias, can be
    several steps of a small result: held to a step of the largest."""
    x, w, b = _conv_inputs(20, 16, 8, 3, seed=2)
    args = _torch_conv_args(x, w, b)
    np.testing.assert_allclose(
        port_conv.conv_relu_pool_fused_reference(*args).numpy(),
        port_conv.conv_relu_pool_reference(*args).numpy(), **TOL)
    args = _torch_conv_args(x, w, b, torch.bfloat16)
    fused = port_conv.conv_relu_pool_fused_reference(*args).float().numpy()
    unfused = port_conv.conv_relu_pool_reference(*args).float().numpy()
    assert np.any(fused != unfused)
    assert np.abs(fused - unfused).max() <= BF16_STEP * np.abs(unfused).max()


def test_fused_block_gradients_match_jax_grad_through_the_pallas_kernel():
    x, w, b = _conv_inputs(20, 16, 8, 3, seed=3)

    def loss(x, w, b):
        return jnp.sum(jax_conv.conv_relu_pool(
            x, w, b, use_pallas=True, interpret=True) ** 2)

    expected = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    args = [t.requires_grad_() for t in _torch_conv_args(x, w, b)]
    out = port_conv.conv_relu_pool(*args, fused=True)
    assert isinstance(out.grad_fn, port_conv.ConvReluPoolFused._backward_cls)
    (out ** 2).sum().backward()
    got = (args[0].grad.numpy(),
           args[1].grad.numpy().transpose(2, 3, 1, 0), args[2].grad.numpy())
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g, np.asarray(e), atol=1e-4, rtol=1e-4)


def test_fused_block_gradients_are_the_unfused_block_s():
    """Backward recomputes the conv output and runs the unfused block's
    own backward, so for one cotangent the two agree to the bit; only a
    needed gradient is computed."""
    x, w, b = _conv_inputs(18, 16, 8, 3, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, 8, 8)).astype(np.float32))
    grads = []
    for fused in (True, False):
        args = [t.requires_grad_() for t in _torch_conv_args(x, w, b)]
        port_conv.conv_relu_pool(*args, fused=fused).backward(g)
        grads.append([t.grad for t in args])
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    args = _torch_conv_args(x, w, b)
    args[1].requires_grad_()
    port_conv.conv_relu_pool(*args, fused=True).backward(g)
    assert args[0].grad is None and torch.equal(args[1].grad, grads[1][1])


@pytest.mark.parametrize("cin,stride,fused_runs", [
    (16, 1, True), (8, 1, False), (16, 2, False)])
def test_dispatch_sends_only_stride_1_and_16_channels_to_the_fused_block(
        cin, stride, fused_runs):
    calls = []
    x, w, b = _conv_inputs(21, cin, 8, 3, seed=6)
    args = _torch_conv_args(x, w, b)
    with _FusedOps(calls):
        got = port_conv.conv_relu_pool(*args, stride=stride, fused=True)
    assert calls == (["vqa::conv_relu_pool_fused"] if fused_runs else [])
    np.testing.assert_allclose(
        got.numpy(), port_conv.conv_relu_pool(*args, stride=stride).numpy(),
        **TOL)


# ------------------------------------------------------- kernel 7: the stem

@pytest.mark.parametrize("h,k", [(34, 3), (21, 3), (28, 5)])
def test_stem_plain_version_matches_the_pallas_kernel(h, k):
    """The three shapes of ``test_stem_patches_kernel_matches_reference``;
    21 gives an odd conv size (floor pooling)."""
    x, w, b = _conv_inputs(h, 3, 8, k, seed=7)
    expected = jax_conv.conv_relu_pool_stem(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    got = port_conv.conv_relu_pool_stem(*_torch_conv_args(x, w, b))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("cin", [1, 3, 4])
@pytest.mark.parametrize("cout", [8, 64])
def test_stem_tensor_core_arithmetic_matches_the_pallas_kernel(k, cin, cout):
    """Kernel 7's tensor-core kernel as plain PyTorch
    (``stem_mma_emulation``: the A rows gathered by the kernel's offsets in
    its K order, padded to 16, times the weight packed as mma's B
    fragments, then the pool) on bf16-exact inputs, against the Pallas stem
    in interpret mode and the plain version: f32 sums in another order."""
    x, w, b = _conv_inputs(19, cin, cout, k, seed=8)
    x = x.astype(jnp.bfloat16).astype(np.float32)
    w = w.astype(jnp.bfloat16).astype(np.float32)
    expected = jax_conv.conv_relu_pool_stem(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    args = _torch_conv_args(x, w, b)
    got = port_conv.stem_mma_emulation(
        args[0], port_conv.pack_stem_weight(args[1]), args[2], k)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)
    np.testing.assert_allclose(
        got.numpy(), port_conv.conv_relu_pool_stem_reference(*args).numpy(),
        **TOL)


def test_stem_is_forward_only():
    x, w, b = _conv_inputs(12, 3, 8, 3)
    args = _torch_conv_args(x, w, b)
    args[1].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        port_conv.conv_relu_pool_stem(*args)
    with torch.no_grad():
        assert port_conv.conv_relu_pool_stem(*args).shape == (2, 5, 5, 8)


# ---------------------------------------------------- kernel 8: LN + MLP

def _mlp_inputs(batch, seq, dim, hidden, seed=0):
    """As ``probe_vit_mlp_fused.make_args``: weights in the JAX layout
    ``[in, out]``."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, seq, dim)).astype(np.float32),
            rng.standard_normal(dim).astype(np.float32),
            rng.standard_normal(dim).astype(np.float32),
            (rng.standard_normal((dim, hidden)) * 0.05).astype(np.float32),
            rng.standard_normal(hidden).astype(np.float32),
            (rng.standard_normal((hidden, dim)) * 0.05).astype(np.float32),
            rng.standard_normal(dim).astype(np.float32))


def _torch_mlp_args(args, dtype=torch.float32):
    x, scale, shift, w1, b1, w2, b2 = args
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
            torch.from_numpy(shift), torch.from_numpy(w1.T.copy()),
            torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
            torch.from_numpy(b2))


@pytest.mark.parametrize("batch,seq,dim,hidden", [(8, 12, 64, 128),
                                                  (3, 7, 32, 96)])
def test_ln_mlp_plain_version_matches_the_pallas_kernel_and_its_reference(
        batch, seq, dim, hidden):
    """Batch 8 takes the probe's eight-image chunks, batch 3 single ones."""
    from experiments import probe_vit_mlp_fused as probe

    args = _mlp_inputs(batch, seq, dim, hidden, seed=8)
    jax_args = [jnp.asarray(a) for a in args]
    got = port_mlp.fused_ln_mlp(*_torch_mlp_args(args)).numpy()
    for expected in (probe.fused_ln_mlp(*jax_args, interpret=True),
                     probe.reference(*jax_args)):
        expected = np.asarray(expected)
        assert np.abs(got - expected).max() <= 1e-5 * np.abs(expected).max()


def test_ln_mlp_plain_version_matches_the_pallas_kernel_in_bf16():
    from experiments import probe_vit_mlp_fused as probe

    args = _mlp_inputs(8, 12, 64, 128, seed=9)
    jax_args = [jnp.asarray(a) for a in args]
    for i in (0, 3, 5):  # x and the two weights, as the probe's make_args
        jax_args[i] = jax_args[i].astype(jnp.bfloat16)
    expected = probe.fused_ln_mlp(*jax_args, interpret=True)
    got = port_mlp.fused_ln_mlp(*_torch_mlp_args(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # ln and the hidden units are rounded on the way; a flipped rounding
    # there moves the output by less than its own rounding step.
    _assert_within_one_bf16_rounding(got.float().numpy(),
                                     expected.astype(jnp.float32))


def test_ln_mlp_adds_the_residual_before_the_cast_unlike_the_block():
    """``VitBlock`` rounds the MLP output before the residual add; the op
    after. Equal in f32, and in bf16 no further apart than that rounding."""
    from dl_vqa_tpu_torch.models.vit import VitBlock

    block = VitBlock(64, 1, 0.0)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 9, 64)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            unfused = block(x.to(dtype), dtype, False, None)
            fused = block(x.to(dtype), dtype, False, None, fused=True)
        assert fused.dtype == dtype
        if dtype == torch.float32:
            np.testing.assert_allclose(fused.numpy(), unfused.numpy(), **TOL)
        else:
            assert not torch.equal(fused, unfused)
            np.testing.assert_allclose(fused.float().numpy(),
                                       unfused.float().numpy(),
                                       atol=2 * BF16_STEP, rtol=2 * BF16_STEP)


def test_ln_mlp_is_forward_only_and_the_block_keeps_gradients():
    args = _torch_mlp_args(_mlp_inputs(2, 3, 64, 64))
    args[3].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        port_mlp.fused_ln_mlp(*args)
    from dl_vqa_tpu_torch.models.vit import VitBlock

    block = VitBlock(64, 1, 0.0)
    out = block(args[0], torch.float32, False, None, fused=True)
    out.sum().backward()  # grad mode on: the unfused code ran
    assert block.mlp_in.weight.grad is not None


# ------------------------------------------------ kernel 9: layout cases

JNP_CASES = {
    "split": lambda v: v.reshape(16, 16, 2, v.shape[-1]).max(axis=2),
    "merge": lambda v: v.reshape(16, 16, 2 * v.shape[-1]),
    "strided": lambda v: jnp.maximum(v[:, 0::2, :], v[:, 1::2, :]),
    "shift": lambda v: jnp.concatenate([v[:, 1:, :], v[:, :1, :]], axis=1),
}


@pytest.mark.parametrize("channels", [64, 128])
@pytest.mark.parametrize("mode", port_layout.MODES)
def test_layout_cases_match_the_probe_s_expressions_to_the_bit(mode,
                                                               channels):
    values = np.random.default_rng(11).standard_normal(
        (16, 32, channels)).astype(np.float32)
    expected = JNP_CASES[mode](jnp.asarray(values, jnp.bfloat16))
    x = torch.from_numpy(values).to(torch.bfloat16)
    got = port_layout.layout_case(x, mode)
    assert got.dtype == torch.bfloat16 and got.shape == expected.shape
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(expected.astype(jnp.float32)))


# ------------------------------------ the wrappers refuse what they cannot run

def _cuda_calls():
    x, w, b = _torch_conv_args(*_conv_inputs(12, 16, 32, 3))
    mlp = _torch_mlp_args(_mlp_inputs(2, 3, 64, 64))
    block = torch.zeros(4, 6, 8)
    return {
        "fused_cpu": lambda: port_conv.conv_relu_pool_fused_cuda(x, w, b),
        "stem_cpu": lambda: port_conv.conv_relu_pool_stem_cuda(x, w, b),
        "fused_weight_shape": lambda: port_conv.conv_relu_pool_fused_cuda(
            x, w[:, :8], b),
        "stem_bias_shape": lambda: port_conv.conv_relu_pool_stem_cuda(
            x, w, b[:3]),
        "ln_mlp_cpu": lambda: port_mlp.fused_ln_mlp_cuda(*mlp),
        "ln_mlp_weight_shape": lambda: port_mlp.fused_ln_mlp_cuda(
            *mlp[:3], mlp[3].t(), *mlp[4:]),
        "layout_cpu": lambda: port_layout.layout_case_cuda(block, "split"),
        "layout_mode": lambda: port_layout.layout_case(block, "transpose"),
        "layout_odd_width": lambda: port_layout.layout_case(
            block[:, :5], "merge"),
    }


@pytest.mark.parametrize("call", sorted(_cuda_calls()))
def test_wrappers_raise_on_what_they_do_not_take(call):
    """On the CPU every ``*_cuda`` wrapper raises: nothing falls back."""
    with pytest.raises(ValueError):
        _cuda_calls()[call]()


# --------------------------------------------------- the slice as a whole

NUM_TOKENS, SEQ, ANSWERS = 30, 6, 20


def _jax_cfg(encoder):
    image = (ImageConfig(encoder="vit", num_channels=(3, 64), patch_size=16,
                         num_layers=2, num_heads=1, dropout=0.0)
             if encoder == "vit" else
             ImageConfig(num_channels=(3, 16, 32, 16), dropout=0.0))
    return JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=0.0),
        image=image,
        attention=AttentionConfig(hidden_dim=12, glimpses=2, dropout=0.0),
        classifier=ClassifierConfig(hidden_dim=20, dropout=0.0),
        max_answers=ANSWERS, image_size=64, num_tokens=NUM_TOKENS)


def _inputs(seed=0, batch=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, 64, 64, 3), dtype=np.uint8)
    lengths = np.array([SEQ, 1, 4, 2, 3, 5, 6, 2][:batch], dtype=np.int32)
    questions = rng.integers(1, NUM_TOKENS, (batch, SEQ)).astype(np.int32)
    questions *= np.arange(SEQ)[None, :] < lengths[:, None]
    return images, questions, lengths


def _model_and_params(encoder, seed=0):
    cfg = _jax_cfg(encoder)
    params = jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(seed), cfg))
    port_cfg = ModelConfig.from_meta_dict(dataclasses.asdict(cfg))
    return cfg, params, load_jax_params(VqaNet(port_cfg, device="cpu"),
                                        params)


@pytest.mark.parametrize("encoder", ["cnn", "vit"])
def test_fused_ops_logits_equal_the_unfused_and_the_jax_logits_in_f32(
        monkeypatch, encoder):
    cfg, params, model = _model_and_params(encoder)
    inputs = _inputs()
    ran = []
    _hook_plain_versions(monkeypatch, ran)
    tensors = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad(), _FusedOps(ran):
        unfused = model(*tensors).numpy()
        assert not ran
        fused = model(*tensors, fused_ops=True).numpy()
        also_plain = model(*tensors, fused_ops=True, plain_ops=True).numpy()
    # The stem and two conv blocks, or the second half of two ViT blocks:
    # their ops, then with plain_ops their plain versions.
    blocks = (["fused_ln_mlp"] * 2 if encoder == "vit" else
              ["conv_relu_pool_stem"] + ["conv_relu_pool_fused"] * 2)
    assert ran == ([f"vqa::{name}" for name in blocks]
                   + [f"{name}_reference" for name in blocks])
    np.testing.assert_array_equal(fused, also_plain)
    np.testing.assert_allclose(fused, unfused, **TOL)
    expected = np.asarray(vqa.apply(
        params, cfg, *(jnp.asarray(a) for a in inputs), train=False,
        compute_dtype=jnp.float32))
    np.testing.assert_allclose(fused, expected, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("encoder", ["cnn", "vit"])
def test_fused_ops_bf16_logits_stay_within_the_roundings_they_move(encoder):
    """bf16: the fused ops round once where the unfused path rounds twice
    (the conv output; the MLP output before the residual). The logits
    move, by far less than they are wide."""
    _, _, model = _model_and_params(encoder, seed=1)
    tensors = [torch.from_numpy(a) for a in _inputs(seed=1)]
    with torch.no_grad():
        unfused = model(*tensors, compute_dtype=torch.bfloat16).numpy()
        fused = model(*tensors, compute_dtype=torch.bfloat16,
                      fused_ops=True).numpy()
    assert np.isfinite(fused).all()
    assert np.abs(fused - unfused).max() <= 2e-2 * np.abs(unfused).max()


@pytest.mark.parametrize("encoder", ["cnn", "vit"])
def test_fused_ops_train_step_takes_the_unfused_step_s_gradients(encoder):
    """With gradients recorded the forward-only ops stay off: the ViT step
    is the unfused one, and the CNN step runs the fused blocks 1 and 2,
    whose backward is the unfused block's. One f32 step, per tensor."""
    cfg, _, _ = _model_and_params(encoder)
    port_cfg = ModelConfig.from_meta_dict(dataclasses.asdict(cfg))
    images, questions, lengths = _inputs(seed=2, batch=8)
    rng = np.random.default_rng(3)
    batch = {"images": images, "questions": questions, "lengths": lengths,
             "answer_indices": rng.integers(1, ANSWERS + 1, (8, 10)).astype(
                 np.int32),
             "answer_values": rng.integers(0, 11, (8, 10)).astype(np.int32)}
    grads = []
    for fused in (False, True):
        model = _model_and_params(encoder)[2]
        state = create_train_state(model, 1e-3, device="cpu")
        step = make_train_step(port_cfg, compute_dtype=torch.float32,
                               fused_ops=fused)
        _, metrics = step(state, batch, torch.Generator().manual_seed(0))
        assert bool(torch.isfinite(metrics["loss"]))
        grads.append({n: p.grad.numpy() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    for name, want in grads[0].items():
        np.testing.assert_allclose(grads[1][name], want, atol=1e-6,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("encoder", ["cnn", "vit"])
def test_fused_ops_eval_step_runs_the_fused_ops_and_keeps_the_loss(
        monkeypatch, encoder):
    """Under the eval step's ``no_grad`` the forward-only ops are on too
    (the stem; the LN + MLP); the f32 loss and score are the unfused
    step's."""
    cfg, _, model = _model_and_params(encoder)
    port_cfg = ModelConfig.from_meta_dict(dataclasses.asdict(cfg))
    images, questions, lengths = _inputs(seed=4, batch=8)
    rng = np.random.default_rng(5)
    batch = {"images": images, "questions": questions, "lengths": lengths,
             "answer_indices": rng.integers(1, ANSWERS + 1, (8, 10)).astype(
                 np.int32),
             "answer_values": rng.integers(0, 11, (8, 10)).astype(np.int32)}
    ran = []
    _hook_plain_versions(monkeypatch, ran)
    with _FusedOps(ran):
        unfused = make_eval_step(port_cfg, compute_dtype=torch.float32)(
            model, batch)
        assert not ran
        fused = make_eval_step(port_cfg, compute_dtype=torch.float32,
                               fused_ops=True)(model, batch)
    assert ran == (["vqa::fused_ln_mlp"] * 2 if encoder == "vit" else
                   ["vqa::conv_relu_pool_stem"]
                   + ["vqa::conv_relu_pool_fused"] * 2)
    np.testing.assert_allclose(float(fused[0]), float(unfused[0]), **TOL)
    assert float(fused[1]) == float(unfused[1])
