"""The port's VqaNet against ``dl_vqa_tpu.models.vqa.apply``, on the CPU,
and its train mode (dropout, the trainable parameters, the device default).

JAX parameters from ``vqa.init`` cross into the port through
``load_jax_params``; the same numpy inputs go through both forwards, in
f32 and in bf16. Tolerance atol 2e-5, rtol 1e-4, as the JAX model's own
parity test against the PyTorch reference (tests/test_model_parity.py).
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
from dl_vqa_tpu.ops.lstm import reverse_valid_prefix
from dl_vqa_tpu.ops.lstm_pallas import lstm_scan_pallas
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet, dropout as port_dropout
from dl_vqa_tpu_torch.utils.params import load_jax_params

NUM_TOKENS = 50
TOL = dict(atol=2e-5, rtol=1e-4)


def _jax_cfg(do_option="+", stride=1, bidirectional=True):
    return JaxModelConfig(
        text=JaxTextConfig(question_features=32, embedding_features=16,
                           dropout=0.0, bidirectional=bidirectional),
        image=JaxImageConfig(num_channels=(3, 8, 12, 16), stride=stride,
                             dropout=0.0),
        attention=JaxAttentionConfig(hidden_dim=24, glimpses=2,
                                     do_option=do_option, dropout=0.0),
        classifier=JaxClassifierConfig(hidden_dim=20, dropout=0.0),
        max_answers=30,
        image_size=64 if stride == 1 else 96,
        num_tokens=NUM_TOKENS,
    )


def _port_cfg(jax_cfg):
    return ModelConfig.from_meta_dict(dataclasses.asdict(jax_cfg))


def _batch(image_size, uint8, seed=0, batch=3):
    rng = np.random.default_rng(seed)
    if uint8:
        images = rng.integers(0, 256, (batch, image_size, image_size, 3),
                              dtype=np.uint8)
    else:
        images = rng.standard_normal(
            (batch, image_size, image_size, 3)).astype(np.float32)
    questions = rng.integers(1, NUM_TOKENS, size=(batch, 7)).astype(np.int32)
    lengths = np.array([7, 1, 5, 3][:batch], dtype=np.int32)
    for i, n in enumerate(lengths):
        questions[i, n:] = 0
    questions[0, 2] = 0  # an unknown token inside the prefix
    return images, questions, lengths


def _both(jax_cfg, images, questions, lengths, seed=0, bf16=False):
    params = vqa.init(jax.random.PRNGKey(seed), jax_cfg)
    expected = np.asarray(vqa.apply(
        params, jax_cfg, jnp.asarray(images), jnp.asarray(questions),
        jnp.asarray(lengths), train=False,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32))
    model = load_jax_params(VqaNet(_port_cfg(jax_cfg), device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(questions),
                    torch.from_numpy(lengths),
                    compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return got.numpy(), expected


def _pallas_bilstm_final_cell(x, lengths, fwd_params, bwd_params,
                              use_pallas=False):
    """The JAX model's bi-LSTM as it runs on a TPU (``use_pallas=True``:
    the Pallas kernel, x_proj and h rounded to bf16), in interpret mode."""
    _, c_fwd = lstm_scan_pallas(x, lengths, fwd_params, interpret=True)
    _, c_bwd = lstm_scan_pallas(reverse_valid_prefix(x, lengths), lengths,
                                bwd_params, interpret=True)
    return jnp.concatenate([c_fwd, c_bwd], axis=-1)


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("do_option", ["+", "*", "|"])
@pytest.mark.parametrize("stride", [1, 2])
def test_logits_match_jax_apply(do_option, stride, uint8):
    cfg = _jax_cfg(do_option, stride)
    got, expected = _both(cfg, *_batch(cfg.image_size, uint8))
    assert got.shape == (3, cfg.max_answers) and got.dtype == np.float32
    np.testing.assert_allclose(got, expected, **TOL)


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("do_option", ["+", "*", "|"])
@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_logits_match_jax_apply(monkeypatch, do_option, stride, uint8):
    """bf16 compute, as the reference config serves, against the JAX
    model's TPU path. Every matmul accumulates in f32 and is rounded to
    bf16 only where JAX rounds it; rounding the attention logits or the
    classifier's products to bf16 as well moves the logits by ~5e-4,
    twenty times this tolerance."""
    monkeypatch.setattr(vqa, "bilstm_final_cell", _pallas_bilstm_final_cell)
    cfg = _jax_cfg(do_option, stride)
    got, expected = _both(cfg, *_batch(cfg.image_size, uint8), bf16=True)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expected, **TOL)


def test_unidirectional_logits_match_jax_apply():
    cfg = _jax_cfg(bidirectional=False)
    got, expected = _both(cfg, *_batch(cfg.image_size, False, seed=1), seed=1)
    np.testing.assert_allclose(got, expected, **TOL)


def test_plain_ops_and_dispatch_agree_on_cpu():
    """On the CPU the dispatch runs the plain versions: same bits."""
    cfg = _port_cfg(_jax_cfg())
    model = VqaNet(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    images, questions, lengths = (torch.from_numpy(a)
                                  for a in _batch(64, True, seed=2))
    with torch.no_grad():
        a = model(images, questions, lengths)
        b = model(images, questions, lengths, plain_ops=True)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_seeded_init_is_deterministic_and_torch_default_scaled():
    cfg = _port_cfg(_jax_cfg())
    m1 = VqaNet(cfg, device="cpu",
                generator=torch.Generator().manual_seed(7))
    m2 = VqaNet(cfg, device="cpu",
                generator=torch.Generator().manual_seed(7))
    for (n1, p1), (n2, p2) in zip(m1.state_dict().items(),
                                  m2.state_dict().items()):
        assert n1 == n2
        torch.testing.assert_close(p1, p2, atol=0, rtol=0)
    emb = m1.text.embedding.weight
    assert torch.all(emb[0] == 0) and emb[1:].std() > 0.5
    bound = 1 / np.sqrt(cfg.text.question_features)
    assert m1.text.lstm.weight_hh_l0.abs().max() <= bound


def test_state_dict_names_are_the_reference_names():
    from dl_vqa_tpu.utils.torch_export import torch_state_from_params

    cfg = _jax_cfg()
    params = jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(0), cfg))
    expected = torch_state_from_params(params)
    state = VqaNet(_port_cfg(cfg), device="cpu").state_dict()
    assert sorted(state) == sorted(expected)
    for name, value in expected.items():
        assert tuple(state[name].shape) == value.shape, name


def test_nonzero_bias_hh_is_summed_into_the_gates():
    """A reference .pth keeps bias_ih and bias_hh apart; the model adds
    them, so moving bias between the two changes nothing."""
    cfg = _port_cfg(_jax_cfg())
    model = VqaNet(cfg, device="cpu")
    images, questions, lengths = (torch.from_numpy(a)
                                  for a in _batch(64, False, seed=3))
    with torch.no_grad():
        before = model(images, questions, lengths)
        shift = torch.linspace(-0.5, 0.5, model.text.lstm.bias_ih_l0.numel())
        model.text.lstm.bias_ih_l0 -= shift
        model.text.lstm.bias_hh_l0 += shift
        after = model(images, questions, lengths)
    torch.testing.assert_close(after, before, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("change", [
    {"text": {"encoder": "transformer"}},
    {"image": {"encoder": "vit", "moe_experts": 8, "num_channels": (3, 64),
               "num_heads": 1, "num_layers": 1}},
    {"attention": {"variant": "stacked"}},
    {"attention": {"variant": "co"}},
], ids=["transformer", "vit", "stacked", "co"])
def test_unported_variants_raise(change):
    """Every variant of the JAX package is ported now, the ViT's MoE blocks
    (the ``vit`` case: one block of eight experts) last: the transformer
    text encoder, the MoE ViT and the stacked and co attention build and
    run (their parity with the JAX package is
    ``tests/test_torch_variants.py``'s and ``tests/test_torch_moe.py``'s):
    on the small model here each gives finite logits of the right shape."""
    cfg = _port_cfg(_jax_cfg())
    for group, fields in change.items():
        cfg = dataclasses.replace(
            cfg, **{group: dataclasses.replace(getattr(cfg, group), **fields)})
    model = VqaNet(cfg, device="cpu")
    images, questions, lengths = (torch.from_numpy(a)
                                  for a in _batch(64, True))
    with torch.no_grad():
        logits = model(images, questions, lengths)
    assert logits.shape == (3, cfg.max_answers)
    assert bool(torch.isfinite(logits).all())


def test_the_dense_vit_builds_with_the_same_heads_behind_it():
    """``image.encoder="vit"`` swaps the image encoder and nothing else:
    the text encoder, the attention and the classifier keep their names,
    and the attention reads the ViT's model width."""
    cfg = dataclasses.replace(
        _port_cfg(_jax_cfg()), image_size=32, image=dataclasses.replace(
            ModelConfig().image, encoder="vit", num_channels=(3, 64),
            num_layers=1, num_heads=1))
    model = VqaNet(cfg, device="cpu")
    cnn = VqaNet(_port_cfg(_jax_cfg()), device="cpu")
    outside = [n for n in model.state_dict() if not n.startswith("image.")]
    assert outside == [n for n in cnn.state_dict()
                       if not n.startswith("image.")]
    assert model.attention.v_conv.weight.shape[1] == 64
    assert tuple(model.image.pos.shape) == (4, 64)
    images, questions, lengths = (torch.from_numpy(a)
                                  for a in _batch(32, True))
    with torch.no_grad():
        assert model(images, questions, lengths).shape == (3, cfg.max_answers)


@pytest.mark.parametrize("rate,threshold", [
    (0.0, 256), (0.3, 179), (0.5, 128), (1 / 512, 256), (1.0, 0)])
def test_dropout_keep_probability_is_quantised_to_256ths(rate, threshold):
    """``threshold = round((1 - rate) * 256)``: the kept share is
    ``threshold / 256`` and the kept values are divided by exactly that;
    256 (rates 0 and 1/512) returns x itself, 0 returns zeros. The same
    quantisation as the JAX model's ``_dropout``."""
    assert int(round((1.0 - rate) * 256.0)) == threshold
    x = torch.arange(1, 40001, dtype=torch.float32).reshape(200, 200)
    gen = torch.Generator().manual_seed(5)
    out = port_dropout(x, rate, gen)
    expected = vqa._dropout(jnp.asarray(x.numpy()), rate, True,
                            jax.random.PRNGKey(0))
    if threshold == 256:
        assert out is x and np.array_equal(np.asarray(expected), x.numpy())
        return
    if threshold == 0:
        assert torch.all(out == 0) and not np.asarray(expected).any()
        return
    kept = out != 0
    torch.testing.assert_close(out[kept], (x / (threshold / 256.0))[kept],
                               atol=0, rtol=0)
    # 40,000 draws: the kept share within 4 standard deviations, for the
    # port's masks and for the JAX model's.
    q = threshold / 256.0
    slack = 4 * np.sqrt(q * (1 - q) / x.numel())
    assert abs(float(kept.float().mean()) - q) < slack
    jax_kept = np.asarray(expected) != 0
    assert abs(jax_kept.mean() - q) < slack
    np.testing.assert_array_equal(np.asarray(expected)[jax_kept],
                                  (x.numpy() / np.float32(q))[jax_kept])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_preserves_the_mean_and_the_dtype(dtype):
    x = torch.ones(400, 400, dtype=dtype)
    out = port_dropout(x, 0.3, torch.Generator().manual_seed(6))
    assert out.dtype == dtype and out.shape == x.shape
    # Kept values are 256/179; their share is 179/256 +- 4 sigma.
    q = 179 / 256
    assert abs(float(out.float().mean()) - 1.0) < 4 * np.sqrt(
        (1 - q) / q / x.numel()) + (4e-3 if dtype == torch.bfloat16 else 0)


def test_dropout_masks_follow_the_generator_seed():
    x = torch.ones(64, 64)
    a = port_dropout(x, 0.5, torch.Generator().manual_seed(9))
    b = port_dropout(x, 0.5, torch.Generator().manual_seed(9))
    c = port_dropout(x, 0.5, torch.Generator().manual_seed(10))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert port_dropout(x, 0.5, None) is x  # eval: no generator, no dropout


def _dropout_cfg():
    cfg = _jax_cfg()
    return _port_cfg(dataclasses.replace(
        cfg, **{group: dataclasses.replace(getattr(cfg, group), dropout=0.3)
                for group in ("text", "image", "attention", "classifier")}))


def test_train_mode_needs_a_generator_and_draws_from_it():
    """``train=True`` without a generator raises, as the JAX model does
    without an rng; with one, the same seed gives the same logits, another
    seed and eval mode give other logits, and gradients reach every
    trainable parameter."""
    cfg = _dropout_cfg()
    model = VqaNet(cfg, device="cpu")
    images, questions, lengths = (torch.from_numpy(a)
                                  for a in _batch(64, False))
    with pytest.raises(ValueError, match="generator"):
        model(images, questions, lengths, train=True)

    def run(seed):
        return model(images, questions, lengths, train=True,
                     generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    with torch.no_grad():
        evaluated = model(images, questions, lengths)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, evaluated)
    a.sum().backward()
    for name, p in model.named_parameters():
        assert (p.grad is not None) == ("bias_hh" not in name), name
    # In eval mode a generator changes nothing.
    with torch.no_grad():
        again = model(images, questions, lengths,
                      generator=torch.Generator().manual_seed(1))
    assert torch.equal(again, evaluated)


def test_only_one_lstm_bias_per_direction_is_trainable():
    """The JAX package trains one fused ``b``; two trainable biases would
    both take Adam's step and move their sum twice as far."""
    model = VqaNet(_port_cfg(_jax_cfg()), device="cpu")
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"text.lstm.bias_hh_l0", "text.lstm.bias_hh_l0_reverse"}
    assert {"text.lstm.bias_ih_l0", "text.lstm.bias_ih_l0_reverse"} <= trainable
    assert set(model.state_dict()) == trainable | frozen


def test_default_device_is_the_gpu_and_its_absence_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda.*device=\"cpu\""):
        VqaNet(_port_cfg(_jax_cfg()))
