"""The attention and text variants of the port against the JAX package, on
the CPU: the per-token bi-LSTM states, the transformer question encoder,
stacked attention and co-attention, the whole forward and the gradients of
the loss for every combination of text encoder and attention variant the
JAX package tests (``tests/test_variants.py``) and the ViT under
(transformer, co), the weight bridge and the checkpoints of both variant
presets (their entry points are ``tests/test_torch_variants_entry.py``'s).

The same seeded numpy inputs and JAX parameters (``vqa.init``, crossed
over by the bridge) go through both packages, at small widths: a CNN
3 -> 8 -> 8 -> 16 at 32 px, H = 16, a transformer 32 wide with 4 heads and
2 layers, a hidden width of 16, 10 answers, T = 7 with lengths 7, 1, 4 and
3. Tolerances are the single variant's (``tests/test_torch_model.py``,
``tests/test_torch_train.py``): logits atol 2e-5 and rtol 1e-4 in f32 and
in bf16, gradients atol 2e-6 and rtol 1e-4 per element.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_vqa_tpu.models import fusion as jax_fusion
from dl_vqa_tpu.models import transformer as jax_transformer
from dl_vqa_tpu.models import vit as jax_vit
from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig, ClassifierConfig, ImageConfig, ModelConfig as JaxConfig,
    TextConfig)
from dl_vqa_tpu.ops import conv_int8 as jax_int8
from dl_vqa_tpu.ops import lstm as jax_lstm
from dl_vqa_tpu.ops import vit_attention_pallas as jax_attention
from dl_vqa_tpu.ops.lstm_pallas import lstm_scan_pallas
from dl_vqa_tpu.train import state as jax_state
from dl_vqa_tpu.train import steps as jax_steps
from dl_vqa_tpu.utils import checkpoint as jax_ckpt
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.fusion import CoAttention, StackedAttention
from dl_vqa_tpu_torch.models.transformer import TransformerText
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.ops import lstm as port_lstm
from dl_vqa_tpu_torch.ops.vqa_metrics import soft_cross_entropy
from dl_vqa_tpu_torch.train import create_train_state, make_train_step
from dl_vqa_tpu_torch.utils import checkpoint as port_ckpt
from dl_vqa_tpu_torch.utils.params import (
    jax_params_from_model, jax_tree_from_named, load_jax_params,
    torch_state_from_params)

NUM_TOKENS, SEQ, IMAGE, ANSWERS = 40, 7, 32, 10
LENGTHS = np.array([7, 1, 4, 3], dtype=np.int32)
TOL = dict(atol=2e-5, rtol=1e-4)        # tests/test_torch_model.py::TOL
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)   # tests/test_torch_train.py
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# The five combinations of tests/test_variants.py, then the ViT under
# (transformer, co).
COMBOS = [("lstm", "stacked", "cnn"), ("lstm", "co", "cnn"),
          ("transformer", "single", "cnn"), ("transformer", "co", "cnn"),
          ("transformer", "stacked", "cnn"), ("transformer", "co", "vit")]
COMBO_IDS = ["-".join(c) for c in COMBOS]


def _jax_cfg(encoder="lstm", variant="single", image="cnn", do_option="+",
             glimpses=2, bidirectional=True):
    return JaxConfig(
        text=TextConfig(encoder=encoder,
                        question_features=16 if encoder == "lstm" else 32,
                        embedding_features=12, dropout=0.0,
                        bidirectional=bidirectional, num_heads=4,
                        num_layers=2, max_positions=8),
        image=(ImageConfig(num_channels=(3, 8, 8, 16), dropout=0.0)
               if image == "cnn" else
               # one head of 64: the head the Pallas attention takes
               ImageConfig(encoder="vit", num_channels=(3, 64), patch_size=8,
                           num_layers=1, num_heads=1, dropout=0.0)),
        attention=AttentionConfig(variant=variant, hidden_dim=16,
                                  glimpses=glimpses, do_option=do_option,
                                  dropout=0.0),
        classifier=ClassifierConfig(hidden_dim=20, dropout=0.0),
        max_answers=ANSWERS, image_size=IMAGE, num_tokens=NUM_TOKENS)


def _port_cfg(jax_cfg):
    return ModelConfig.from_meta_dict(dataclasses.asdict(jax_cfg))


def _params(cfg, seed=0):
    """A JAX parameter tree of ``cfg`` (``vqa.init``'s structure, traced,
    not run) filled from a seeded numpy generator at the init's scales: a
    leaf of fan-in n is U(+-1/sqrt(n)), a layer norm's scale 1 + N(0,
    0.1^2) and its bias N(0, 0.1^2), the embedding N(0, 1) with row 0
    zero, a position table N(0, 0.02^2), any other bias U(+-0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: vqa.init(key, cfg),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        if names[-1] in ("scale", "bias"):
            base = 1.0 if names[-1] == "scale" else 0.0
            return (base + 0.1 * rng.standard_normal(leaf.shape)
                    ).astype(np.float32)
        if names[-1] == "embedding":
            table = rng.standard_normal(leaf.shape).astype(np.float32)
            table[0] = 0.0
            return table
        if names[-1] == "pos":
            return (0.02 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 \
            else 100  # a bias
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _model(cfg, params):
    return load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), params)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    questions = rng.integers(1, NUM_TOKENS, (4, SEQ)).astype(np.int32)
    questions *= np.arange(SEQ)[None, :] < LENGTHS[:, None]
    questions[0, 2] = 0  # an unknown token inside the prefix
    return images, questions, LENGTHS


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pallas_bilstm_final_cell(x, lengths, fwd_params, bwd_params,
                              use_pallas=False):
    """The JAX model's pooled bi-LSTM as it runs on a TPU (the Pallas
    kernel, x_proj and h rounded to bf16), in interpret mode: what the
    port's bf16 recurrence follows. The token scan never takes it."""
    _, c_fwd = lstm_scan_pallas(x, lengths, fwd_params, interpret=True)
    _, c_bwd = lstm_scan_pallas(jax_lstm.reverse_valid_prefix(x, lengths),
                                lengths, bwd_params, interpret=True)
    return jnp.concatenate([c_fwd, c_bwd], axis=-1)


# ------------------------------------------------------------ token states

def _lstm_direction(rng, emb, hidden):
    return {"w_ih": (rng.standard_normal((emb, 4 * hidden)) * 0.3
                     ).astype(np.float32),
            "w_hh": (rng.standard_normal((hidden, 4 * hidden)) * 0.3
                     ).astype(np.float32),
            "b": (rng.standard_normal(4 * hidden) * 0.3).astype(np.float32)}


def _torch_direction(p):
    return {"weight_ih": torch.tensor(p["w_ih"].T, requires_grad=True),
            "weight_hh": torch.tensor(p["w_hh"].T, requires_grad=True),
            "bias": torch.tensor(p["b"], requires_grad=True)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_token_states_and_their_gradients_match_jax(bidirectional, dtype):
    """``bilstm_tokens_and_final_cell`` (``lstm_scan_outputs_final`` for
    one direction) on x rounded to the compute dtype, as the JAX model
    feeds it: the states run in f32 on both sides (x_proj and W_hh are not
    rounded to bf16), so f32 tolerances hold in bf16 too. The backward
    direction's states sit at their original positions and every pad is
    zero. The gradients of a weighted sum of the states and the cells
    carry a cotangent at every step into the recurrence's backward."""
    rng = np.random.default_rng(3)
    jdt, tdt = DTYPES[dtype]
    x = np.tanh(rng.standard_normal((4, SEQ, 12))).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    fwd, bwd = _lstm_direction(rng, 12, 16), _lstm_direction(rng, 12, 16)
    lengths = jnp.asarray(LENGTHS)

    def jax_fn(x, fwd, bwd):
        if bidirectional:
            return jax_lstm.bilstm_tokens_and_final_cell(
                x.astype(jdt), lengths, fwd, bwd)
        states, cell = jax_lstm.lstm_scan_outputs_final(x.astype(jdt),
                                                        lengths, fwd)
        return states * (jnp.arange(SEQ)[None, :] < lengths[:, None]
                         )[..., None], cell

    tokens, cells = jax_fn(jnp.asarray(x), fwd, bwd)
    g_tok = rng.standard_normal(tokens.shape).astype(np.float32)
    g_cell = rng.standard_normal(cells.shape).astype(np.float32)
    grads = jax.grad(lambda *a: sum(
        (out * g).sum() for out, g in zip(jax_fn(*a), (g_tok, g_cell))),
        argnums=(0, 1, 2))(jnp.asarray(x), fwd, bwd)

    xt = torch.tensor(x, requires_grad=True)
    tf, tb = _torch_direction(fwd), _torch_direction(bwd)
    if bidirectional:
        got, got_cells = port_lstm.bilstm_tokens_and_final_cell(
            xt.to(tdt), torch.from_numpy(LENGTHS), tf, tb)
        assert torch.equal(got, port_lstm.bilstm_token_states(
            xt.to(tdt), torch.from_numpy(LENGTHS), tf, tb))
    else:
        states, got_cells = port_lstm.lstm_scan_outputs_final(
            xt.to(tdt), torch.from_numpy(LENGTHS), tf)
        mask = torch.arange(SEQ)[None, :] < torch.from_numpy(LENGTHS)[:, None]
        got = states * mask[..., None]
    assert got.dtype == torch.float32 and got_cells.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(tokens),
                               **TOL)
    np.testing.assert_allclose(got_cells.detach().numpy(), np.asarray(cells),
                               **TOL)
    for b, n in enumerate(LENGTHS):
        assert not got[b, n:].any()
    if bidirectional:
        # Position 0's backward state has read the whole valid prefix: it
        # is the direction's final h, which the reversal puts back there.
        assert got[1, 0, 16:].abs().sum() > 0
    ((got * torch.from_numpy(g_tok)).sum()
     + (got_cells * torch.from_numpy(g_cell)).sum()).backward()
    # In bf16 both packages round x's cotangent to bf16 (the cast's
    # backward): one bf16 step apart where the f32 sums straddle a rounding.
    np.testing.assert_allclose(
        xt.grad.numpy(), np.asarray(grads[0]),
        **(GRAD_TOL if dtype == "f32" else dict(atol=2e-6, rtol=2 ** -7)))
    for port, want in ((tf, grads[1]), (tb, grads[2])):
        if not bidirectional and port is tb:
            assert port["weight_hh"].grad is None
            continue
        np.testing.assert_allclose(port["weight_ih"].grad.numpy().T,
                                   np.asarray(want["w_ih"]), **GRAD_TOL)
        np.testing.assert_allclose(port["weight_hh"].grad.numpy().T,
                                   np.asarray(want["w_hh"]), **GRAD_TOL)
        np.testing.assert_allclose(port["bias"].grad.numpy(),
                                   np.asarray(want["b"]), **GRAD_TOL)


def test_token_states_without_a_gradient_take_the_custom_op():
    """No gradient asked: ``vqa::lstm_token_states`` (its plain version on
    the CPU), the same bits as the differentiable path and the plain one,
    and ``lstm_scan_outputs`` is the states of ``..._final``."""
    rng = np.random.default_rng(4)
    x = torch.tanh(torch.from_numpy(
        rng.standard_normal((4, SEQ, 12)).astype(np.float32)))
    p = {k: v.detach() for k, v in _torch_direction(
        _lstm_direction(rng, 12, 16)).items()}
    lengths = torch.from_numpy(LENGTHS)
    x_proj = port_lstm.input_projections([x], [p])
    w = p["weight_hh"].unsqueeze(0)
    op = torch.ops.vqa.lstm_token_states(x_proj, w, lengths.int())
    plain = port_lstm.lstm_token_states(x_proj, w, lengths, plain=True)
    grad = port_lstm.lstm_token_states(x_proj.requires_grad_(), w, lengths)
    for other in (plain, grad):
        for a, b in zip(op, other):
            assert torch.equal(a, b.detach())
    with torch.no_grad():
        states = port_lstm.lstm_scan_outputs(x, lengths, p)
    assert torch.equal(states, op[0][0].transpose(0, 1))


# ------------------------------------------------------------ transformer

def _transformer_params(seed=0):
    cfg = _jax_cfg("transformer")
    params = _params(cfg, seed)["text"]
    rng = np.random.default_rng(seed)
    for layer in params["layers"]:  # layer norms away from 1 and 0
        for ln in ("ln1", "ln2"):
            layer[ln] = {k: (v + rng.standard_normal(v.shape) * 0.1
                             ).astype(np.float32)
                         for k, v in layer[ln].items()}
    return cfg, params


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_transformer_text_matches_apply_transformer_text(dtype):
    """Pooled, tokens and mask of ``TransformerText`` against
    ``apply_transformer_text``, the unknown token inside a prefix
    included."""
    jdt, tdt = DTYPES[dtype]
    cfg, params = _transformer_params()
    _, questions, lengths = _inputs()
    want = jax_transformer.apply_transformer_text(
        params, jnp.asarray(questions), jnp.asarray(lengths), 4, 0.0, False,
        None, jdt)
    model = _model(cfg, _params(cfg) | {"text": params})
    with torch.no_grad():
        got = model.text(torch.from_numpy(questions),
                         torch.from_numpy(lengths), tdt, False, None,
                         need_tokens=True)
    assert isinstance(model.text, TransformerText)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_transformer_text_refuses_a_question_past_max_positions():
    cfg, params = _transformer_params()
    questions = np.ones((2, 9), dtype=np.int32)
    lengths = np.array([9, 3], dtype=np.int32)
    with pytest.raises(ValueError, match="positional table size 8") as jax_e:
        jax_transformer.apply_transformer_text(
            params, jnp.asarray(questions), jnp.asarray(lengths), 4, 0.0,
            False, None)
    model = _model(cfg, _params(cfg))
    with pytest.raises(ValueError) as port_e:
        model.text(torch.from_numpy(questions), torch.from_numpy(lengths),
                   torch.float32, False, None)
    assert str(port_e.value) == str(jax_e.value)


# ------------------------------------------------------------ fusion

def _fusion_inputs(seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((4, 3, 3, 16)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    tokens = rng.standard_normal((4, SEQ, 32)).astype(np.float32)
    mask = np.arange(SEQ)[None, :] < LENGTHS[:, None]
    return v, q, tokens * mask[..., None], mask


@pytest.mark.parametrize("glimpses", [2, 1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("do_option", ["+", "*", "|"])
def test_stacked_attention_matches_apply_stacked_attention(do_option, dtype,
                                                           glimpses):
    """One glimpse has no ``update`` (an empty list of updates); '|' scores
    a ``2 mid`` concat."""
    jdt, tdt = DTYPES[dtype]
    cfg = _jax_cfg("transformer", "stacked", do_option=do_option,
                   glimpses=glimpses)
    params = _params(cfg)
    assert ["update" in layer for layer in params["attention"]["layers"]] \
        == [True] * (glimpses - 1) + [False]
    v, q, _, _ = _fusion_inputs(5)
    want = jax_fusion.apply_stacked_attention(
        params["attention"], jnp.asarray(v), jnp.asarray(q), do_option,
        lambda x, site: x, jdt)
    module = _model(cfg, params).attention
    assert isinstance(module, StackedAttention)
    with torch.no_grad():
        got = module(torch.from_numpy(v), torch.from_numpy(q), tdt, None)
    assert got.shape == (4, glimpses * 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("do_option", ["+", "*", "|"])
def test_co_attention_matches_apply_co_attention(do_option, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = _jax_cfg("transformer", "co", do_option=do_option)
    params = _params(cfg)
    v, q, tokens, mask = _fusion_inputs(6)
    want = jax_fusion.apply_co_attention(
        params["attention"], *(jnp.asarray(a) for a in (v, q, tokens, mask)),
        do_option, lambda x, site: x, jdt)
    module = _model(cfg, params).attention
    assert isinstance(module, CoAttention)
    with torch.no_grad():
        got = module(*(torch.from_numpy(a) for a in (v, q, tokens, mask)),
                     tdt, None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
def test_logits_match_jax_apply(monkeypatch, combo, dtype):
    """bf16 against the JAX model's TPU path, where the pooled bi-LSTM is
    the Pallas kernel (as in tests/test_torch_model.py) and the ViT runs
    its conv patch embed and the Pallas attention (interpret mode), as
    ``tests/test_torch_vit.py::tpu_path`` sets it up; there the two
    frameworks' exp and rsqrt move a bf16 rounding now and then, so the
    ViT in bf16 takes that file's tolerance (median 1e-6, atol 2e-4)."""
    jdt, tdt = DTYPES[dtype]
    vit_bf16 = combo[2] == "vit" and dtype == "bf16"
    if dtype == "bf16":
        monkeypatch.setattr(vqa, "bilstm_final_cell",
                            _pallas_bilstm_final_cell)
    if vit_bf16:
        from tests.test_torch_vit import _JaxOnTpu

        pallas = jax_attention.vit_attention_qkv_pallas
        monkeypatch.setattr(jax_vit, "jax", _JaxOnTpu())
        monkeypatch.setattr(jax_attention, "vit_attention_qkv_pallas",
                            lambda qkv, heads: pallas(qkv, heads, True))
    cfg = _jax_cfg(*combo)
    params = _params(cfg)
    images, questions, lengths = _inputs()
    expected = np.asarray(vqa.apply(
        params, cfg, jnp.asarray(images), jnp.asarray(questions),
        jnp.asarray(lengths), compute_dtype=jdt))
    model = _model(cfg, params)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(questions),
                    torch.from_numpy(lengths), compute_dtype=tdt)
        plain = model(torch.from_numpy(images), torch.from_numpy(questions),
                      torch.from_numpy(lengths), compute_dtype=tdt,
                      plain_ops=True)
    assert got.shape == (4, ANSWERS) and got.dtype == torch.float32
    assert torch.equal(got, plain)  # on the CPU the ops are the plain ones
    if vit_bf16:
        assert np.median(np.abs(got.numpy() - expected)) <= 1e-6
        np.testing.assert_allclose(got.numpy(), expected, atol=2e-4, rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), expected, **TOL)


@pytest.mark.parametrize("store", ["f8e4m3", "int8"])
@pytest.mark.parametrize("combo", [("lstm", "stacked", "cnn"),
                                   ("transformer", "co", "cnn")],
                         ids=["san", "transformer_co"])
def test_the_quantized_image_modes_serve_the_variants(combo, store):
    """The f8 store and the int8 stem behind the variants, as in the JAX
    package: a model of the compute mode switched by ``configure``, the
    int8 scales calibrated by the port equal to the JAX package's (1e-6
    relative), and the logits the JAX model's in f32 within the single
    variant's quantized tolerance (``tests/test_torch_quant.py``: atol
    2e-4, a code moved by conv0's sum order)."""
    base = _jax_cfg(*combo)
    params = _params(base)
    images, questions, lengths = _inputs()
    model = _model(base, params)
    if store == "int8":
        calibration = _inputs(1)[0]
        scales = tuple(jax_int8.calibrate_stem_scales(
            params, base, jnp.asarray(calibration), dtype=jnp.float32))
        port = model.int8_calibrated(calibration, dtype=torch.float32)
        np.testing.assert_allclose(port.image.quant_scales, scales,
                                   rtol=1e-6)
    else:
        scales = ()
    cfg = dataclasses.replace(base, image=dataclasses.replace(
        base.image, store_dtype=store, quant_scales=scales))
    want = np.asarray(vqa.apply(
        params, cfg, jnp.asarray(images), jnp.asarray(questions),
        jnp.asarray(lengths), compute_dtype=jnp.float32))
    model.configure(_port_cfg(cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(questions),
                    torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    images, questions, lengths = _inputs(seed)
    return {"images": images, "questions": questions, "lengths": lengths,
            "answer_indices": rng.integers(0, ANSWERS + 1, (4, 10)
                                           ).astype(np.int32),
            "answer_values": rng.integers(0, 11, (4, 10)).astype(np.int32),
            "answer_types": np.zeros(4, dtype=np.int32),
            "mask": np.array([1, 1, 0, 1], dtype=bool)}


@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
def test_gradients_of_the_loss_match_jax_grad(combo):
    """f32, dropout 0, per tensor under the JAX names, a padded sample
    included. A bias that only shifts a softmax (the glimpse scores) and,
    for '|', the query's path into the scores have gradient zero; the
    atol covers their rounding noise."""
    cfg = _jax_cfg(*combo)
    params, batch = _params(cfg), _batch()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        return jax_steps._forward_loss(p, cfg, jax_batch, True,
                                       jax.random.PRNGKey(0), jnp.float32)[0]

    # Jitted: one compile, where op by op each operation compiles.
    expected_loss, expected = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _model(cfg, params)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(t["images"], t["questions"], t["lengths"], train=True,
                   generator=torch.Generator().manual_seed(0))
    loss = soft_cross_entropy(logits, t["answer_indices"],
                              t["answer_values"], t["mask"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(expected_loss),
                               rtol=1e-5)
    got = _flat(jax_tree_from_named(
        {n: p.grad for n, p in model.named_parameters()
         if p.grad is not None}))
    want = _flat(expected)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, err_msg=key, **GRAD_TOL)
    assert max(np.abs(g).max() for g in got.values()) > 1e-2


def test_train_mode_draws_the_variant_sites_and_reaches_every_tensor():
    """Dropout 0.3 everywhere: the same generator seed gives the same
    logits, another seed others, and every trainable tensor of (lstm, co)
    and (transformer, stacked) gets a gradient."""
    images, questions, lengths = (torch.from_numpy(a) for a in _inputs())
    for combo in (("lstm", "co", "cnn"), ("transformer", "stacked", "cnn")):
        cfg = _port_cfg(_jax_cfg(*combo))
        cfg = dataclasses.replace(cfg, **{
            part: dataclasses.replace(getattr(cfg, part), dropout=0.3)
            for part in ("text", "image", "attention", "classifier")})
        model = VqaNet(cfg, device="cpu")

        def run(seed):
            return model(images, questions, lengths, train=True,
                         generator=torch.Generator().manual_seed(seed))

        a, b, c = run(1), run(1), run(2)
        assert torch.equal(a, b) and not torch.equal(a, c)
        a.sum().backward()
        for name, p in model.named_parameters():
            assert (p.grad is not None) == p.requires_grad, name


# ------------------------------------------------------------ bridge

@pytest.mark.parametrize("combo", COMBOS + [("lstm", "co", "cnn", "|", 1)],
                         ids=COMBO_IDS + ["lstm-co-uni"])
def test_bridge_round_trips_each_tree_to_the_bit(combo):
    """JAX tree -> state dict -> VqaNet -> JAX tree is the identity (lists
    of layers as lists), and the port's names are what it builds."""
    if len(combo) == 5:
        cfg = _jax_cfg(*combo[:3], do_option=combo[3], bidirectional=False)
    else:
        cfg = _jax_cfg(*combo)
    params = _params(cfg, seed=2)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.01).astype(np.float32),
        params)
    state = torch_state_from_params(params)
    model = _model(cfg, params)
    assert sorted(model.state_dict()) == sorted(state)
    back = jax_params_from_model(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    got, want = _flat(back), _flat(params)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("missing", [
    ("text", "layers", 1, "mlp_out"), ("text", "pos"),
    ("attention", "layers", 0, "score"), ("attention", "tok_out"),
    ("attention", "v_conv")])
def test_bridge_names_the_leaf_a_malformed_tree_lacks(missing):
    variant = "co" if missing[1] in ("tok_out", "v_conv") else "stacked"
    params = _params(_jax_cfg("transformer", variant))
    node = params
    for key in missing[:-1]:
        node = node[key]
    del node[missing[-1]]
    name = ".".join(str(k) for k in missing)
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        torch_state_from_params(params)


# ------------------------------------------------------------ checkpoints

LR = 1e-3


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("preset", ["config_san", "config_transformer_co"])
def test_a_checkpoint_of_either_package_restores_in_the_other(tmp_path,
                                                              preset, writer):
    """The preset's variant at small widths: a full train state (params,
    Adam's moments and counts, the step; lists of layers under ``#i``
    keys) written by one package comes back in the other equal to the
    bit."""
    cfg = (_jax_cfg("lstm", "stacked") if preset == "config_san"
           else _jax_cfg("transformer", "co"))
    params = _params(cfg)
    path = str(tmp_path / "state.ckpt")
    tx = jax_steps.make_optimizer(LR)
    if writer == "port":
        state = create_train_state(_model(cfg, params), LR, device="cpu")
        batch = {k: v for k, v in _batch().items() if k != "answer_types"}
        state, _ = make_train_step(_port_cfg(cfg), torch.float32)(
            state, batch, 0)
        port_ckpt.save_checkpoint(path, state, epoch=2,
                                  model_cfg=_port_cfg(cfg))
        restored, meta = jax_ckpt.restore_state_meta(
            jax_state.create_train_state(_params(cfg, seed=7), tx), path)
        trainable = {n: p for n, p in state.model.named_parameters()
                     if p.requires_grad}
        want = {"params": jax_params_from_model(state.model), **{
            key: jax_tree_from_named(
                {n: state.optimizer.state[p][slot]
                 for n, p in trainable.items()})
            for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}}
        got = {"params": restored.params, "mu": restored.opt_state[0].mu,
               "nu": restored.opt_state[0].nu}
        assert int(restored.step) == 1
        assert int(restored.opt_state[0].count) == 1
    else:
        jstate = jax_state.create_train_state(params, tx)
        rng = np.random.default_rng(8)
        grads = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            params)
        _, opt_state = jax.jit(tx.update)(grads, jstate.opt_state,
                                          jstate.params)
        jstate = jstate.replace(opt_state=opt_state, step=jnp.asarray(1))
        jax_ckpt.save_checkpoint(path, jstate, epoch=2,
                                 model_cfg=_port_cfg(cfg))
        state = create_train_state(_model(cfg, _params(cfg, seed=7)), LR,
                                   device="cpu")
        state, meta = port_ckpt.restore_state_meta(state, path)
        trainable = {n: p for n, p in state.model.named_parameters()
                     if p.requires_grad}
        got = {"params": jax_params_from_model(state.model), **{
            key: jax_tree_from_named(
                {n: state.optimizer.state[p][slot]
                 for n, p in trainable.items()})
            for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}}
        want = {"params": params, "mu": opt_state[0].mu,
                "nu": opt_state[0].nu}
        assert state.step == 1
    assert meta["epoch"] == 2
    assert ModelConfig.from_meta_dict(meta["model_cfg"]) == _port_cfg(cfg)
    for name in ("params", "mu", "nu"):
        g, w = _flat(got[name]), _flat(want[name])
        assert g.keys() == w.keys()
        for key, value in w.items():
            np.testing.assert_array_equal(g[key], value, err_msg=name + key)
    with np.load(path) as data:
        lists = ("params|attention|layers|#1|score|w"
                 if preset == "config_san"
                 else "params|text|layers|#1|mlp_out|b")
        assert lists in data.files
