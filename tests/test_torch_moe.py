"""The port's mixture-of-experts ViT (``image.moe_experts > 0``) against
``dl_vqa_tpu``, on the CPU at small sizes: the gating against
``dl_vqa_tpu/ops/moe.py::top_k_gating`` (top-k 1, 2 and 3, drops past
capacity, ties, underflow, a token that all its experts dropped), the MoE
layer's forward and gradients against ``jax.grad``, the index path against
the one-hot einsums it replaces, the MoE ViT model's logits and a train
step against the JAX model on its accelerator path (as
``tests/test_torch_vit.py::tpu_path`` runs it), the accumulated step, the
bridge and the loop's balance scalar with a resume mid-epoch.

Inputs come from numpy seeds and go to both sides. Routing is compared
before values: where it differs, the values cannot agree. Tolerances are
stated at each test.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dl_vqa_tpu.ops import moe as jax_moe
from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.train import state as jax_state
from dl_vqa_tpu.train import steps as jax_steps
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.ops import moe
from dl_vqa_tpu_torch.train import create_train_state, make_train_step
from dl_vqa_tpu_torch.utils.params import (
    jax_params_from_model,
    jax_tree_from_named,
    load_jax_params,
    torch_state_from_params,
)
from tests.test_torch_loop import (
    _CrashingBatcher,
    _jax_cfg as _loop_cfg,
    _last,
    _port_run,
    corpus,  # noqa: F401  (a fixture)
)
from tests.test_torch_vit import (
    DTYPES,
    TOL,
    _assert_trees_close,
    _batch,
    _flat,
    _inputs,
    _jax_cfg,
    _params,
    _port_cfg,
    tpu_path,  # noqa: F401  (a fixture)
)

EXPERTS = 4


def _np_logits(shape, seed, skew=0.0):
    """Router logits ``[G, S, E]``; ``skew`` adds a preference for the
    first experts, so that capacity drops tokens."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32)
    logits += skew * np.linspace(1.0, 0.0, shape[-1], dtype=np.float32)
    return logits


def _jax_routing(logits, top_k, capacity):
    fn = jax.jit(jax_moe.top_k_gating, static_argnums=(1, 2))
    return [np.asarray(t) for t in fn(jnp.asarray(logits), top_k, capacity)]


# ---------------------------------------------------------------- gating

@pytest.mark.parametrize("tokens,experts,top_k,factor", [
    (196, 8, 2, 1.25), (16, 4, 1, 1.0), (16, 4, 3, 1.25), (1, 8, 1, 0.1)])
def test_capacity_is_the_jax_packages(tokens, experts, top_k, factor):
    """``config_vit_moe`` (196 tokens, 8 experts, top-2, 1.25) has 62."""
    assert moe.moe_capacity(tokens, experts, top_k, factor) == \
        jax_moe.moe_capacity(tokens, experts, top_k, factor)
    if tokens == 196:
        assert moe.moe_capacity(tokens, experts, top_k, factor) == 62


@pytest.mark.parametrize("factor", [1.0, 1.25])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_gating_matches_jax(top_k, factor):
    """``dispatch`` equal to the bit, ``combine`` within 1e-6 and ``aux``
    within 1e-6 relative: the f32 router softmax and the means differ from
    XLA's by sums in another order, a few f32 steps of values of order
    1. The skewed logits drop slots past capacity at factor 1.0."""
    logits = _np_logits((3, 16, EXPERTS), seed=top_k, skew=2.0)
    capacity = moe.moe_capacity(16, EXPERTS, top_k, factor)
    dispatch, combine, aux = _jax_routing(logits, top_k, capacity)
    routing = moe.top_k_gating(torch.from_numpy(logits), top_k, capacity)
    got_dispatch, got_combine = routing.dense(EXPERTS, capacity)
    np.testing.assert_array_equal(got_dispatch.numpy(), dispatch)
    np.testing.assert_allclose(got_combine.numpy(), combine, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(routing.aux), float(aux), rtol=1e-6)
    kept = int(routing.kept.sum())
    assert kept == int(dispatch.sum())
    if factor == 1.0:
        assert kept < 3 * 16 * top_k  # drops past capacity


def test_ties_and_underflow_choose_as_jax_does():
    """Exact ties go to the first expert; where every other probability has
    underflowed to 0 the second slot takes an expert already taken (expert
    0 or the first): the same dispatch as the JAX function's."""
    logits = np.zeros((1, 6, EXPERTS), np.float32)        # all tied
    logits[0, 3] = [0.0, 0.5, 0.5, 0.0]                   # a tie for first
    logits[0, 4] = [-200.0, 200.0, -200.0, -200.0]        # others underflow
    logits[0, 5] = [200.0, -200.0, -200.0, -200.0]
    for top_k in (1, 2, 3):
        dispatch, combine, _ = _jax_routing(logits, top_k, 6)
        routing = moe.top_k_gating(torch.from_numpy(logits), top_k, 6)
        got_dispatch, got_combine = routing.dense(EXPERTS, 6)
        np.testing.assert_array_equal(got_dispatch.numpy(), dispatch)
        np.testing.assert_allclose(got_combine.numpy(), combine, atol=1e-6)
    routing = moe.top_k_gating(torch.from_numpy(logits), 2, 6)
    assert routing.expert[0, 4].tolist() == [1, 0]
    assert routing.expert[0, 5].tolist() == [0, 0]  # taken again


def test_a_token_all_its_experts_dropped_has_a_finite_backward():
    """Every token prefers experts 0 and 1 and the capacity is 2: the later
    tokens are dropped from both. Their gate sum is 0 and the ``+ 1e-9``
    keeps the backward of ``g / (gate_sum + 1e-9)`` finite: the router
    gradient is finite and equals ``jax.grad``'s within 1e-6."""
    logits = _np_logits((2, 8, EXPERTS), seed=5) * 0.1
    logits[..., :2] += 4.0
    cot = np.random.default_rng(6).standard_normal(
        (2, 8, EXPERTS, 2)).astype(np.float32)

    def jax_loss(x):
        _, combine, aux = jax_moe.top_k_gating(x, 2, 2)
        return jnp.sum(combine * jnp.asarray(cot)) + aux

    expected = np.asarray(jax.grad(jax_loss)(jnp.asarray(logits)))
    leaf = torch.from_numpy(logits).requires_grad_(True)
    routing = moe.top_k_gating(leaf, 2, 2)
    assert int((~routing.kept).all(dim=-1).sum()) > 0  # all-dropped tokens
    _, combine = routing.dense(EXPERTS, 2)
    (combine * torch.from_numpy(cot)).sum().add(routing.aux).backward()
    assert bool(torch.isfinite(leaf.grad).all())
    np.testing.assert_allclose(leaf.grad.numpy(), expected, atol=1e-6)


# ---------------------------------------------------------------- the layer

def _layer(seed, dim=32, hidden=64, experts=EXPERTS):
    """JAX ``init_moe_mlp`` parameters (numpy) and the port's tensors."""
    params = jax.tree_util.tree_map(np.asarray, jax_moe.init_moe_mlp(
        jax.random.PRNGKey(seed), dim, hidden, experts))
    port = {"gate": params["gate"]["w"].T,
            "w_in": params["in"]["w"].transpose(0, 2, 1),
            "b_in": params["in"]["b"],
            "w_out": params["out"]["w"].transpose(0, 2, 1),
            "b_out": params["out"]["b"]}
    return params, {k: torch.from_numpy(np.array(v)) for k, v in port.items()}


def _dense_moe(x, p, top_k, factor):
    """The port's layer with the JAX package's one-hot einsums in place of
    the index path: the oracle of the index path's bits."""
    dtype = x.dtype
    groups, tokens, _ = x.shape
    capacity = moe.moe_capacity(tokens, EXPERTS, top_k, factor)
    routing = moe.top_k_gating(torch.matmul(x.float(), p["gate"].t()),
                               top_k, capacity)
    dispatch, combine = routing.dense(EXPERTS, capacity)
    xin = torch.einsum("gsec,gsd->egcd", dispatch, x.float()).to(dtype)
    xin = xin.reshape(EXPERTS, groups * capacity, -1)
    hidden = torch.relu(torch.bmm(xin.float(), p["w_in"].to(dtype).float()
                                  .transpose(1, 2))
                        + p["b_in"][:, None, :]).to(dtype)
    y = (torch.bmm(hidden.float(), p["w_out"].to(dtype).float()
                   .transpose(1, 2)) + p["b_out"][:, None, :]).to(dtype)
    y = y.reshape(EXPERTS, groups, capacity, -1)
    return torch.einsum("gsec,egcd->gsd", combine.to(dtype).float(),
                        y.float()).to(dtype)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_the_index_path_gives_the_one_hot_einsums_bits(top_k, name):
    """A dispatched element is one term plus zeros, and a combined one of
    ``top_k <= 2`` in bf16 two exact f32 products summed and rounded once:
    the index path's output equals the einsums' to the bit, drops
    included. In f32 a product is itself rounded, and the einsum's fused
    multiply-add may skip the second product's rounding: top-1 is still
    one rounding (equal to the bit), top-2 within one f32 step."""
    _, tdt = DTYPES[name]
    _, p = _layer(1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 16, 32)).astype(np.float32)).to(tdt)
    got = moe.moe_mlp(x, p["gate"], p["w_in"], p["b_in"], p["w_out"],
                      p["b_out"], top_k, 1.0)
    assert got.dtype == tdt and got.shape == x.shape
    want = _dense_moe(x, p, top_k, 1.0)
    if name == "f32" and top_k == 2:
        torch.testing.assert_close(got, want, atol=1e-7, rtol=2 ** -22)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_moe_layer_matches_jax_forward_and_gradients(name):
    """Top-2 at factor 1.25 with slots left empty: the routing equal to the
    JAX function's first (dispatch to the bit), then the output and the
    gradients of the input, the router and the expert weights and biases
    against ``jax.grad`` of ``sum(out * cot) + aux``. f32: 1e-5 absolute
    (sums in another order). bf16: the products round where JAX's do, so
    most values are equal; an f32 sum taken in another order now and then
    moves a rounding by one bf16 step (2^-8 of the value), and a
    gradient's sums over the tokens carry those steps: 2e-2 absolute on
    gradients of order 1 and fewer than 1 in 100 outputs off at all."""
    jdt, tdt = DTYPES[name]
    params, p = _layer(3)
    rng = np.random.default_rng(4)
    x_np = rng.standard_normal((3, 16, 32)).astype(np.float32)
    cot = rng.standard_normal((3, 16, 32)).astype(np.float32)
    capacity = moe.moe_capacity(16, EXPERTS, 2, 1.25)

    x_j = jnp.asarray(x_np).astype(jdt)
    logits_j = jnp.einsum("gsd,de->gse", x_j.astype(jnp.float32),
                          params["gate"]["w"])
    dispatch = _jax_routing(np.asarray(logits_j), 2, capacity)[0]
    assert (dispatch.sum(axis=1) == 0).any()  # slots that hold no token

    def jax_loss(x, prm):
        sink = []
        out = jax_moe.moe_mlp(x, prm, 2, 1.25, jdt, aux_sink=sink)
        return jnp.sum(out.astype(jnp.float32) * cot) + sink[0], out

    (_, expected), grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(x_j, params)

    x = torch.from_numpy(x_np).to(tdt).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    routing = moe.top_k_gating(torch.matmul(x.detach().float(),
                                            leaves["gate"].detach().t()),
                               2, capacity)
    np.testing.assert_array_equal(
        routing.dense(EXPERTS, capacity)[0].numpy(), dispatch)
    sink = []
    out = moe.moe_mlp(x, leaves["gate"], leaves["w_in"], leaves["b_in"],
                      leaves["w_out"], leaves["b_out"], 2, 1.25, sink)
    (out.float() * torch.from_numpy(cot)).sum().add(
        moe.balance_loss(*sink[0])).backward()
    got_grads = {
        "x": x.grad.float().numpy(),
        "gate": leaves["gate"].grad.numpy().T,
        "in_w": leaves["w_in"].grad.numpy().transpose(0, 2, 1),
        "in_b": leaves["b_in"].grad.numpy(),
        "out_w": leaves["w_out"].grad.numpy().transpose(0, 2, 1),
        "out_b": leaves["b_out"].grad.numpy()}
    want_grads = {
        "x": np.asarray(grads[0].astype(jnp.float32)),
        "gate": np.asarray(grads[1]["gate"]["w"]),
        "in_w": np.asarray(grads[1]["in"]["w"]),
        "in_b": np.asarray(grads[1]["in"]["b"]),
        "out_w": np.asarray(grads[1]["out"]["w"]),
        "out_b": np.asarray(grads[1]["out"]["b"])}
    got_out = out.detach().float().numpy()
    want_out = np.asarray(expected.astype(jnp.float32))
    if name == "f32":
        np.testing.assert_allclose(got_out, want_out, atol=1e-5, rtol=0)
        atol = 1e-5
    else:
        np.testing.assert_allclose(got_out, want_out, atol=2e-2, rtol=2 ** -7)
        assert (got_out != want_out).mean() < 0.01
        atol = 2e-2
    for key, want in want_grads.items():
        assert np.abs(want).max() > 1e-3, key
        np.testing.assert_allclose(got_grads[key], want, atol=atol,
                                   rtol=1e-4, err_msg=key)


# ---------------------------------------------------------------- the model

def _moe_cfg(**kw):
    return _jax_cfg(moe=EXPERTS, **kw)


@functools.lru_cache(maxsize=None)
def _moe_params(layers, image_size):
    """The JAX initial weights of ``_moe_cfg``, made once a shape by the
    jitted init (the eager one takes seconds); callers must not change
    them."""
    init = jax.jit(vqa.init, static_argnums=(1,))
    return jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(0), _moe_cfg(layers=layers, image_size=image_size)))


def test_bridge_maps_the_moe_tree_and_a_dense_model_refuses_it():
    """The MoE leaves under the port's names (gate ``[E, D]``, expert
    weights ``[E, out, in]``), a legacy list of layers stacked first, and a
    dense model given a MoE tree raises the JAX model's ``ValueError``."""
    params = _moe_params(2, 64)
    state = torch_state_from_params(params)
    assert state["image.blocks.1.moe.gate"].shape == (EXPERTS, 128)
    assert state["image.blocks.0.moe.in.weight"].shape == (EXPERTS, 512, 128)
    assert state["image.blocks.0.moe.out.weight"].shape == (EXPERTS, 128, 512)
    np.testing.assert_array_equal(
        state["image.blocks.1.moe.out.weight"],
        params["image"]["layers"]["moe"]["out"]["w"][1].transpose(0, 2, 1))
    legacy = dict(params, image=dict(params["image"], layers=[
        jax.tree_util.tree_map(lambda x, i=i: x[i],
                               params["image"]["layers"])
        for i in range(2)]))
    again = torch_state_from_params(legacy)
    assert again.keys() == state.keys()
    for key in state:
        np.testing.assert_array_equal(again[key], state[key], err_msg=key)
    dense = VqaNet(_port_cfg(_jax_cfg(layers=2, image_size=64)), device="cpu")
    with pytest.raises(ValueError, match="no MoE routing config"):
        load_jax_params(dense, params)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_moe_vit_logits_and_aux_match_the_jax_accelerator_path(tpu_path,
                                                                name):
    """Two MoE blocks at 64 px (16 tokens, C = 10): the balance losses of
    both blocks within 1e-6 relative in f32 (means in another order) and
    1e-4 in bf16 (the router reads bf16 activations, which one-step flips
    of a rounding move, and so the probabilities' means), and the logits
    at the dense ViT's tolerances (f32: ``TOL``; bf16: the largest
    difference 2e-4, the median 1e-6, as
    ``test_vit_bf16_logits_match_the_jax_accelerator_path`` states
    them)."""
    tpu_path()
    jdt, tdt = DTYPES[name]
    cfg = _moe_cfg(image_size=64)
    params = _moe_params(2, 64)
    inputs = _inputs(64, uint8=True, seed=3)
    def apply(p, *arrays):
        aux = []
        out = vqa.apply(p, cfg, *arrays, compute_dtype=jdt, aux_sink=aux)
        return out, aux

    # Eager in bf16, as the dense ViT's bf16 test runs it: jit lets XLA
    # fuse bf16 elementwise chains and skip roundings that the ops state.
    run = jax.jit(apply) if name == "f32" else apply
    expected, sink = run(params, *(jnp.asarray(a) for a in inputs))
    expected = np.asarray(expected)
    model = load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), params)
    got_sink = []
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs), compute_dtype=tdt,
                    aux_sink=got_sink).numpy()
    np.testing.assert_allclose([float(moe.balance_loss(*a))
                                for a in got_sink],
                               [float(a) for a in sink],
                               rtol=1e-6 if name == "f32" else 1e-4)
    if name == "f32":
        np.testing.assert_allclose(got, expected, **TOL)
    else:
        assert np.median(np.abs(got - expected)) <= 1e-6
        np.testing.assert_allclose(got, expected, atol=2e-4, rtol=0)


def test_moe_vit_train_gradients_match_jax_grad(tpu_path):
    """The training loss with ``moe_aux_weight`` times the layer mean of
    the balance losses, and every gradient under the JAX names (router and
    experts included) against ``jax.grad`` of the JAX step's loss, f32:
    the dense ViT's atol 2e-6, rtol 1e-4. One block, 32 px."""
    cfg = _moe_cfg(layers=1)
    params, batch = _moe_params(1, 32), _batch(1)

    def loss_fn(p):
        return jax_steps._forward_loss(
            p, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, True,
            jax.random.PRNGKey(0), jnp.float32)[0]

    expected_loss, expected = jax.jit(jax.value_and_grad(loss_fn))(params)
    from dl_vqa_tpu_torch.ops.vqa_metrics import soft_cross_entropy
    from dl_vqa_tpu_torch.train.steps import _balance_loss, _forward_sums

    model = load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), params)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, logits, balance = _forward_sums(
        model, model.cfg, tensors, True, torch.Generator().manual_seed(0),
        torch.float32, False, False)
    aux, _ = _balance_loss(balance, None)
    loss = soft_cross_entropy(logits, tensors["answer_indices"],
                              tensors["answer_values"], tensors.get("mask"))
    loss = loss + model.cfg.image.moe_aux_weight * aux
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(expected_loss),
                               rtol=1e-5)
    assert 0.5 < float(aux.detach()) < 4.0
    got = jax_tree_from_named({n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None})
    _assert_trees_close(got, expected, 2e-6, 1e-4, "gradient of")
    assert np.abs(got["image"]["layers"]["moe"]["gate"]["w"]).max() > 1e-5


def test_the_accumulated_step_weighs_moe_aux_as_jax_does():
    """Two micro-batches of a padded batch: the port's ``moe_aux`` is the
    micro-batches' balance losses weighted by their real counts, each
    micro's the one its own forward gives, and the loss and ``moe_aux``
    equal the JAX accumulated step's within 1e-5 relative (f32 sums in
    another order). The unaccumulated step reports the whole batch's."""
    cfg = _moe_cfg(layers=1)
    params, batch = _moe_params(1, 32), _batch(2)
    tx = jax_steps.make_optimizer(1e-3)
    reports = {}
    for accum in (1, 2):
        jax_train = jax_state.create_train_state(
            jax.tree_util.tree_map(jnp.asarray, params), tx)
        _, jax_metrics = jax_steps.make_train_step(
            cfg, tx, compute_dtype=jnp.float32, accum_steps=accum)(
                jax_train, {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(0))
        state = create_train_state(
            load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), params),
            1e-3, device="cpu")
        _, metrics = make_train_step(_port_cfg(cfg), torch.float32,
                                     accum_steps=accum)(state, batch, 0)
        reports[accum] = metrics
        for key in ("loss", "moe_aux"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(jax_metrics[key]), rtol=1e-5,
                                       err_msg=f"accum {accum} {key}")
    model = load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), params)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    per_micro, counts = [], []
    for rows in (slice(0, 4), slice(4, 8)):
        sink = []
        with torch.no_grad():
            model(tensors["images"][rows], tensors["questions"][rows],
                  tensors["lengths"][rows], aux_sink=sink)
        per_micro.append(sum(float(moe.balance_loss(*a)) for a in sink)
                         / len(sink))
        counts.append(float(tensors["mask"][rows].sum()))
    weighted = np.dot(per_micro, counts) / sum(counts)
    np.testing.assert_allclose(float(reports[2]["moe_aux"]), weighted,
                               rtol=1e-6)
    sink = []
    with torch.no_grad():
        model(tensors["images"], tensors["questions"], tensors["lengths"],
              aux_sink=sink)
    np.testing.assert_allclose(float(reports[1]["moe_aux"]),
                               sum(float(moe.balance_loss(*a))
                                   for a in sink) / len(sink),
                               rtol=1e-6)


# ---------------------------------------------------------------- the loop

def _loop_moe_cfg(corpus):
    """The loop tests' model with a ViT of one MoE block at their 24 px:
    patch 8, nine tokens, a head of 64, four experts."""
    cfg = _loop_cfg(corpus["port"][0].num_tokens, dropout=0.3)
    return dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, encoder="vit", num_channels=(3, 64), patch_size=8,
        num_layers=1, num_heads=1, moe_experts=EXPERTS))


def test_the_loop_reports_moe_balance_and_resumes_mid_epoch_to_the_bit(
        corpus, tmp_path):
    """``Loss/MoEBalanceTrain`` each epoch (the epoch's mean of the steps'
    ``moe_aux``, about 1 at balance), carried through a mid-epoch save in
    ``epoch_accum["aux"]``: the run that crashes after batch 5 of epoch 1
    and resumes from batch 4 ends with the uninterrupted run's parameters,
    Adam moments, step and scalars, to the bit."""
    cfg = _loop_moe_cfg(corpus)
    straight, straight_log = _port_run(corpus, cfg, 4, str(tmp_path / "a"),
                                       table=True, batch_size=8)
    balance = straight_log.scalars["Loss/MoEBalanceTrain"]
    assert len(balance) == 2 and all(0.9 < b < 4.0 for b in balance)
    with pytest.raises(RuntimeError, match="went away"):
        _port_run(corpus, cfg, 4, str(tmp_path / "b"),
                  batcher_cls=_CrashingBatcher, table=True, batch_size=8)
    from dl_vqa_tpu_torch.utils import checkpoint as port_ckpt

    _, meta = port_ckpt.restore_state_meta(
        create_train_state(VqaNet(_port_cfg(cfg), device="cpu"), 1e-3,
                           device="cpu"),
        str(tmp_path / "b" / "last.ckpt"))
    assert set(meta["epoch_accum"]) == {"loss", "score", "aux"}
    resumed, resumed_log = _port_run(
        corpus, cfg, 8, str(tmp_path / "c"), table=True, batch_size=8,
        opt_restore_path=str(tmp_path / "b" / "last.ckpt"))
    assert resumed == straight
    assert resumed_log.scalars["Loss/MoEBalanceTrain"] == balance[1:]
    a, c = _last(str(tmp_path / "a")), _last(str(tmp_path / "c"))
    assert a.keys() == c.keys()
    assert any("|moe|" in key for key in a)
    for key in a:
        np.testing.assert_array_equal(c[key], a[key], err_msg=key)


def test_a_port_moe_model_round_trips_through_the_jax_tree():
    """The port's own MoE weights -> the JAX tree -> the port, to the bit,
    and the JAX model gives the port's f32 logits (``TOL``)."""
    cfg = _moe_cfg(image_size=64)
    model = VqaNet(_port_cfg(cfg), device="cpu",
                   generator=torch.Generator().manual_seed(7))
    model.text.lstm.fold_biases()  # the fused LSTM bias, as the tree holds it
    tree = jax_params_from_model(model)
    again = load_jax_params(VqaNet(_port_cfg(cfg), device="cpu"), tree)
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    inputs = _inputs(64, uint8=False, seed=9)
    expected = np.asarray(vqa.apply(tree, cfg,
                                    *(jnp.asarray(a) for a in inputs)))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs)).numpy()
    np.testing.assert_allclose(got, expected, **TOL)
    assert _flat(tree).keys() == _flat(_moe_params(2, 64)).keys()
