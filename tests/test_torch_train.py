"""The port's train and eval steps against ``dl_vqa_tpu.train.steps``, on
the CPU, in f32 at dropout 0 (the two frameworks cannot draw the same
masks): gradients at step 0, 50 Adam steps, gradient accumulation on an
unevenly padded batch, the eval step with its breakdown, the LR schedule.

The same numpy parameters (``vqa.init``) and the same numpy batch go
through both. Tolerances are stated at each test.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig,
    ClassifierConfig,
    ImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig,
)
from dl_vqa_tpu.train import state as jax_state
from dl_vqa_tpu.train import steps as jax_steps
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.train import (
    create_train_state,
    lr_schedule,
    make_eval_step,
    make_train_step,
)
from dl_vqa_tpu_torch.utils.params import (
    jax_params_from_model,
    jax_tree_from_named,
    load_jax_params,
)

NUM_TOKENS, SEQ, ANSWERS, IMAGE = 30, 6, 50, 32
LR = 1e-3


def _jax_cfg(do_option="+", dropout=0.0):
    return JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=dropout),
        image=ImageConfig(num_channels=(3, 8, 16), dropout=dropout),
        attention=AttentionConfig(hidden_dim=12, glimpses=2,
                                  do_option=do_option, dropout=dropout),
        classifier=ClassifierConfig(hidden_dim=20, dropout=dropout),
        max_answers=ANSWERS, image_size=IMAGE, num_tokens=NUM_TOKENS)


def _port_cfg(jax_cfg):
    return ModelConfig.from_meta_dict(dataclasses.asdict(jax_cfg))


def _batch(seed, batch=8, real=None):
    """The layout of ``bench.py::make_batch`` at a small size; ``real``
    marks which samples are not padding."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, SEQ + 1, batch).astype(np.int32)
    lengths[0], lengths[-1] = 1, SEQ
    questions = rng.integers(0, NUM_TOKENS, (batch, SEQ)).astype(np.int32)
    questions *= np.arange(SEQ)[None, :] < lengths[:, None]
    out = {
        "images": rng.standard_normal(
            (batch, IMAGE, IMAGE, 3)).astype(np.float32),
        "questions": questions,
        "lengths": lengths,
        "answer_indices": rng.integers(
            0, ANSWERS + 1, (batch, 10)).astype(np.int32),
        "answer_values": rng.integers(0, 11, (batch, 10)).astype(np.int32),
        "answer_types": rng.integers(0, 3, batch).astype(np.int32),
        "mask": np.ones(batch, dtype=bool),
    }
    if real is not None:
        out["mask"] = np.asarray(real, dtype=bool)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(seed), cfg))


def _model(cfg, params):
    return load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), params)


def _assert_trees_close(got, expected, atol, rtol, what):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_expected = dict(jax.tree_util.tree_flatten_with_path(expected)[0])
    assert flat_got.keys() == flat_expected.keys()
    for path, value in flat_expected.items():
        np.testing.assert_allclose(
            flat_got[path], np.asarray(value), atol=atol, rtol=rtol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("do_option", ["+", "*", "|"])
def test_gradients_at_step_0_match_jax_grad(do_option):
    """Per tensor, under the JAX names. f32 sums in another order through
    a conv stack, an LSTM and two softmaxes: atol 2e-6 on gradients whose
    largest entries are of order 1e-1, rtol 1e-4."""
    cfg = _jax_cfg(do_option)
    params, batch = _params(cfg), _batch(1, real=[1, 1, 1, 0, 1, 1, 0, 1])

    def loss_fn(p):
        return jax_steps._forward_loss(p, cfg, _jax_batch(batch), True,
                                       jax.random.PRNGKey(0), jnp.float32)[0]

    expected_loss, expected = jax.value_and_grad(loss_fn)(params)
    model = _model(cfg, params)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(tensors["images"], tensors["questions"],
                   tensors["lengths"], train=True,
                   generator=torch.Generator().manual_seed(0))
    from dl_vqa_tpu_torch.ops.vqa_metrics import soft_cross_entropy

    loss = soft_cross_entropy(logits, tensors["answer_indices"],
                              tensors["answer_values"], tensors["mask"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(expected_loss),
                               rtol=1e-5)
    got = jax_tree_from_named(
        {n: p.grad for n, p in model.named_parameters()
         if p.grad is not None})
    _assert_trees_close(got, expected, 2e-6, 1e-4, "gradient of")
    assert max(np.abs(g).max() for g in jax.tree_util.tree_leaves(got)) > 1e-2


def _run_jax(cfg, params, batches, accum_steps=1):
    tx = jax_steps.make_optimizer(LR)
    state = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax_steps.make_train_step(cfg, tx, compute_dtype=jnp.float32,
                                     jit=True, accum_steps=accum_steps)
    losses, scores = [], []
    for batch in batches:
        state, metrics = step(state, _jax_batch(batch), jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
        scores.append(float(metrics["score"]))
    return state, losses, scores


def _run_port(cfg, model, batches, accum_steps=1):
    state = create_train_state(model, LR, device="cpu")
    step = make_train_step(_port_cfg(cfg), compute_dtype=torch.float32,
                           accum_steps=accum_steps)
    gen = torch.Generator().manual_seed(0)
    losses, scores = [], []
    for batch in batches:
        batch = {k: v for k, v in batch.items() if k != "answer_types"}
        state, metrics = step(state, batch, gen)
        assert metrics["loss"].dim() == 0 and metrics["score"].dim() == 0
        losses.append(float(metrics["loss"]))
        scores.append(float(metrics["score"]))
    return state, losses, scores


def _deltas(after, before):
    return jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), after, before)


def test_50_adam_steps_match_the_jax_train_step():
    """Four batches in turn for 50 steps, f32, dropout 0, against the
    jitted JAX step with optax's Adam. Per-step loss within 1e-4 relative.
    Parameter deltas (each of order 50 * LR = 5e-2 at most) within 5e-4
    absolute (half of one Adam step; the two runs take their f32 sums in
    other orders, and 50 steps carry that on: 2e-4 was seen with some
    thread counts, 3e-7 with others) wherever the gradient is clear of
    rounding noise: Adam
    divides by sqrt(v), so an entry whose gradient is itself noise (the
    attention's glimpse bias, whose gradient is zero by the softmax's shift
    invariance; a unit the ReLU keeps shut) takes steps of size LR in a
    direction that the order of an f32 sum decides. "Clear" is read from
    the JAX run's own second moment: a root-mean-square gradient above
    1e-6. More than nine tenths of all entries are, every LSTM entry among
    them; the rest stay within Adam's bound of LR a step."""
    cfg = _jax_cfg()
    params = _params(cfg)
    batches = [_batch(10 + i % 4) for i in range(50)]
    jax_final, jax_losses, jax_scores = _run_jax(cfg, params, batches)
    state, losses, scores = _run_port(cfg, _model(cfg, params), batches)
    assert state.step == 50 and int(jax_final.step) == 50
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    np.testing.assert_allclose(scores, jax_scores, atol=1e-6)
    assert losses[48] < losses[0]  # the same batch, twelve rounds later
    got = _deltas(jax_params_from_model(state.model), params)
    expected = _deltas(jax_final.params, params)
    second_moment = jax_final.opt_state[0].nu
    flat = [dict(jax.tree_util.tree_flatten_with_path(t)[0])
            for t in (got, expected, second_moment)]
    assert flat[0].keys() == flat[1].keys()
    compared = total = 0
    for path, want in flat[1].items():
        name = jax.tree_util.keystr(path)
        rms = np.sqrt(np.asarray(flat[2][path]) / (1.0 - 0.999 ** 50))
        clear = rms > 1e-6
        if "lstm" in name:
            assert clear.all(), name
        compared += int(clear.sum())
        total += clear.size
        np.testing.assert_allclose(flat[0][path][clear], want[clear],
                                   atol=5e-4, rtol=0,
                                   err_msg=f"50-step delta of {name}")
        np.testing.assert_allclose(flat[0][path], want, atol=2 * 50 * LR,
                                   rtol=0, err_msg=f"50-step delta of {name}")
    assert compared > 0.9 * total
    moved = np.abs(expected["text"]["lstm_fwd"]["b"]).max()
    assert moved > 10 * LR  # the fused bias did move, and by Adam's step


def test_20_steps_move_the_fused_lstm_bias_as_jax_moves_b():
    """The port starts with the bias split unevenly over ``bias_ih`` and
    ``bias_hh``; only one of the two is trained, so the sum moves as the
    JAX package's single ``b`` does. Were both trained, both would take
    Adam's step and the delta would be twice JAX's."""
    cfg = _jax_cfg()
    params = _params(cfg, seed=1)
    batches = [_batch(20 + i % 2) for i in range(20)]
    jax_final, _, _ = _run_jax(cfg, params, batches)
    model = _model(cfg, params)
    with torch.no_grad():
        for suffix in ("", "_reverse"):
            shift = torch.linspace(-0.3, 0.3, 64)
            getattr(model.text.lstm, f"bias_ih_l0{suffix}").sub_(shift)
            getattr(model.text.lstm, f"bias_hh_l0{suffix}").add_(shift)
    frozen = model.text.lstm.bias_hh_l0.clone()
    state, _, _ = _run_port(cfg, model, batches)
    assert torch.equal(model.text.lstm.bias_hh_l0, frozen)
    got = jax_params_from_model(state.model)["text"]
    for name in ("lstm_fwd", "lstm_bwd"):
        expected_delta = (np.asarray(jax_final.params["text"][name]["b"])
                          - params["text"][name]["b"])
        delta = got[name]["b"] - params["text"][name]["b"]
        assert np.abs(expected_delta).max() > 5 * LR
        # 1e-4 absolute on deltas of up to 2e-2; a doubled step would be
        # off by the delta itself.
        np.testing.assert_allclose(delta, expected_delta, atol=1e-4)


def test_accumulation_matches_the_whole_batch_on_an_uneven_padding():
    """A padded final batch whose real samples fall 2, 1, 0, 2 over four
    micro-batches: accum_steps=4 gives the loss, the score, the gradient
    and the update of accum_steps=1. f32 sums in another order: 1e-6
    relative on the loss, atol 1e-7 and rtol 1e-5 on gradients of up to
    0.8. Adam's first step is LR * g / (|g| + eps), so the updates are
    compared where |g| > 1e-6, to 1e-3 of LR: below that a gradient entry
    is rounding noise (the attention's glimpse bias has gradient zero by
    the softmax's shift invariance) and its step is noise of size LR. Both
    runs match the JAX step with the same accumulation."""
    cfg = _jax_cfg()
    params = _params(cfg, seed=2)
    batch = _batch(30, real=[1, 1, 1, 0, 0, 0, 1, 1])
    results = {}
    for accum in (1, 4):
        state, losses, scores = _run_port(cfg, _model(cfg, params), [batch],
                                          accum_steps=accum)
        grads = jax_tree_from_named(
            {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None})
        results[accum] = (jax_params_from_model(state.model), losses[0],
                          scores[0], grads)
        jax_final, jax_losses, jax_scores = _run_jax(cfg, params, [batch],
                                                     accum_steps=accum)
        np.testing.assert_allclose(losses[0], jax_losses[0], rtol=1e-5)
        np.testing.assert_allclose(scores[0], jax_scores[0], atol=1e-6)
    np.testing.assert_allclose(results[4][1], results[1][1], rtol=1e-6)
    assert results[4][2] == results[1][2]
    _assert_trees_close(results[4][3], results[1][3], 1e-7, 1e-5,
                        "accumulated gradient of")
    whole, split = (_deltas(results[a][0], params) for a in (1, 4))
    compared = 0
    for a, b, g in zip(*(jax.tree_util.tree_leaves(t)
                         for t in (whole, split, results[1][3]))):
        clear = np.abs(g) > 1e-6
        compared += int(clear.sum())
        np.testing.assert_allclose(b[clear], a[clear], atol=LR * 1e-3, rtol=0)
    assert compared > 1000
    with pytest.raises(ValueError, match="does not split"):
        _run_port(cfg, _model(cfg, params), [batch], accum_steps=3)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "padded"])
def test_eval_step_with_breakdown_matches_jax(masked):
    cfg = _jax_cfg()
    params = _params(cfg, seed=3)
    batch = _batch(40, real=[1, 0, 1, 1, 1, 0, 1, 1] if masked else None)
    expected = jax_steps.make_eval_step(
        cfg, compute_dtype=jnp.float32, with_breakdown=True)(
            jax.tree_util.tree_map(jnp.asarray, params), _jax_batch(batch))
    model = _model(cfg, params)
    got = make_eval_step(_port_cfg(cfg), compute_dtype=torch.float32,
                         with_breakdown=True)(model, batch)
    assert len(got) == 4 and not got[0].requires_grad
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-6,
                                   rtol=1e-5)
    plain = make_eval_step(_port_cfg(cfg),
                           compute_dtype=torch.float32)(model, batch)
    assert len(plain) == 2 and torch.equal(plain[0], got[0])


@pytest.mark.parametrize("count", [0, 1, 50_000])
def test_lr_schedule_halves_every_50000_updates(count):
    expected = float(jax_steps.lr_schedule(LR)(jnp.asarray(count)))
    assert lr_schedule(LR)(count) == pytest.approx(expected, rel=1e-6)
    assert lr_schedule(LR)(0) == LR and lr_schedule(LR)(50_000) == LR / 2


def test_the_step_sets_the_lr_of_the_update_it_makes():
    cfg = _jax_cfg()
    state = create_train_state(VqaNet(_port_cfg(cfg), device="cpu"), LR,
                               device="cpu")
    state.step = 50_000
    step = make_train_step(_port_cfg(cfg), compute_dtype=torch.float32)
    batch = {k: v for k, v in _batch(50).items() if k != "answer_types"}
    step(state, batch, torch.Generator().manual_seed(0))
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(LR / 2)
    assert state.step == 50_001
    trained = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    assert id(state.model.text.lstm.bias_hh_l0) not in trained
    assert id(state.model.text.lstm.bias_ih_l0) in trained


def test_dropout_train_step_runs_and_draws_per_micro_batch():
    """Dropout 0.3 at every site: the step runs, the loss is finite, and
    two micro-batches with the same content get different masks."""
    cfg = _jax_cfg(dropout=0.3)
    half = _batch(60, batch=4)
    batch = {k: np.concatenate([v, v]) for k, v in half.items()
             if k != "answer_types"}
    model = VqaNet(_port_cfg(cfg), device="cpu")
    logits = []
    hook = model.register_forward_hook(
        lambda _m, _i, out: logits.append(out.detach()))
    state = create_train_state(model, LR, device="cpu")
    step = make_train_step(_port_cfg(cfg), compute_dtype=torch.float32,
                           accum_steps=2)
    _, metrics = step(state, batch, torch.Generator().manual_seed(0))
    hook.remove()
    assert torch.isfinite(metrics["loss"]) and state.step == 1
    assert len(logits) == 2 and not torch.equal(logits[0], logits[1])


@pytest.mark.parametrize("entry", ["create_train_state", "make_train_step",
                                   "make_eval_step"])
def test_training_entry_points_default_to_the_gpu(entry):
    """The placement is decided where the model and the state are made:
    both default to the GPU and raise without one. The steps take no
    device; they run where the model they are given lies."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _port_cfg(_jax_cfg())
    if entry == "create_train_state":
        with pytest.raises(RuntimeError, match="cuda"):
            create_train_state(VqaNet(cfg, device="cpu"), LR)
        return
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(VqaNet(cfg), LR)
    state = create_train_state(VqaNet(cfg, device="cpu"), LR, device="cpu")
    batch = {k: v for k, v in _batch(70).items() if k != "answer_types"}
    if entry == "make_train_step":
        _, metrics = make_train_step(cfg, compute_dtype=torch.float32)(
            state, batch, torch.Generator().manual_seed(0))
        out = metrics["loss"]
    else:
        out = make_eval_step(cfg, compute_dtype=torch.float32)(
            state.model, batch)[0]
    assert out.device.type == "cpu" and torch.isfinite(out)
