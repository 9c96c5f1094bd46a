"""The port's train loop and checkpoints against ``dl_vqa_tpu``'s, on the
CPU in f32 at tiny widths: the device image table in the step, npz
checkpoints read by the other package both ways, a ``.pth`` import,
``train()`` of both packages from one initial state, and the port's own
guarantees (a mid-epoch crash resumed to the bit, the exhausted budget,
the mid-epoch cadence without ``save_model``, an async save taken while
the run goes on). Dropout masks cannot match JAX's, so the comparisons
with JAX run at dropout 0; the port's resume runs with dropout on.
Tolerances are stated at each test."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dl_vqa_tpu import config as jax_config
from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu.data.dataset import VQADataset as JaxDataset
from dl_vqa_tpu.data.pipeline import Batcher as JaxBatcher
from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig,
    ClassifierConfig,
    ImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig,
)
from dl_vqa_tpu.train import loop as jax_loop
from dl_vqa_tpu.train import state as jax_state
from dl_vqa_tpu.train import steps as jax_steps
from dl_vqa_tpu.utils import checkpoint as jax_ckpt
from dl_vqa_tpu_torch.data.dataset import VQADataset
from dl_vqa_tpu_torch.data.pipeline import Batcher
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.train import create_train_state, make_train_step
from dl_vqa_tpu_torch.train import loop as port_loop
from dl_vqa_tpu_torch.utils import checkpoint as port_ckpt
from dl_vqa_tpu_torch.utils.params import (
    jax_params_from_model,
    jax_tree_from_named,
    load_jax_params,
)

LR = 1e-3
IMAGE = 24


def _jax_cfg(num_tokens, dropout=0.0):
    return JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=dropout),
        image=ImageConfig(num_channels=(3, 4, 6), dropout=dropout),
        attention=AttentionConfig(hidden_dim=12, glimpses=2, dropout=dropout),
        classifier=ClassifierConfig(hidden_dim=16, dropout=dropout),
        max_answers=12, image_size=IMAGE, num_tokens=num_tokens)


def _port_cfg(jax_cfg):
    return ModelConfig.from_meta_dict(dataclasses.asdict(jax_cfg))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    profile = jax_synthetic.make_synthetic_corpus(
        root, n_train=45, n_val=14, n_images=6, image_size=IMAGE,
        max_answers=12, learnable=True)
    return {
        "profile": profile,
        "port": (VQADataset(profile["train_paths"], profile["paths"],
                            answerable_only=True),
                 VQADataset(profile["val_paths"], profile["paths"])),
        "jax": (JaxDataset(profile["train_paths"], profile["paths"],
                           answerable_only=True),
                JaxDataset(profile["val_paths"], profile["paths"])),
    }


def _params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(seed), cfg))


def _model(jax_cfg, params):
    return load_jax_params(VqaNet(_port_cfg(jax_cfg), device="cpu"), params)


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


class _Logger:
    """The logger surface both loops use; keeps what they report."""

    def __init__(self, exp_dir, save=None):
        self.exp_dir = exp_dir
        os.makedirs(exp_dir, exist_ok=True)
        self.lines, self.scalars, self.saves = [], {}, []
        self._save = save

    def write(self, text, epoch=None, **kw):
        self.lines.append(str(text))

    def write_epoch_statistics(self, **kw):
        pass

    def report_scalars(self, scalars, epoch):
        for tag, value in scalars.items():
            self.scalars.setdefault(tag, []).append(float(value))

    def report_scalars_same_plot(self, scalars, epoch):
        pass

    def save_model(self, state, epoch, model_cfg=None, extra_meta=None):
        self.saves.append(epoch)
        if self._save is not None:
            self._save(os.path.join(self.exp_dir, "model.ckpt"), state,
                       epoch=epoch, model_cfg=model_cfg,
                       extra_meta=extra_meta)


def _train_params(num_epochs=2, save_model=True):
    return port_loop.TrainParams(
        n_epochs_stop=50, num_epochs=num_epochs, lr=LR, lr_decay=0.0,
        lr_gamma=0.0, lr_step_size=1, save_model=save_model, max_answers=12)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_a_step_with_the_table_equals_a_step_with_images(corpus, accum_steps):
    """f32, dropout 0.3: the gather of the table rows gives the batch's
    images, and the table is not split into micro-batches; the losses and
    the updated parameters are equal to the bit."""
    train_ds = corpus["port"][0]
    cfg = _jax_cfg(train_ds.num_tokens, dropout=0.3)
    params = _params(cfg)
    table = torch.from_numpy(train_ds.features_nhwc_all())
    with_images = next(Batcher(train_ds, 16, shuffle=True, seed=1)
                       .iter_epoch(0))
    with_rows = next(Batcher(train_ds, 16, shuffle=True, seed=1,
                             load_images=False).iter_epoch(0))
    assert "image_rows" in with_rows and "images" not in with_rows
    with_rows = dict(with_rows, image_table=table)
    step = make_train_step(_port_cfg(cfg), torch.float32,
                           accum_steps=accum_steps)
    results = []
    for batch in (with_images, with_rows):
        state = create_train_state(_model(cfg, params), LR, device="cpu")
        for _ in range(2):
            state, metrics = step(state, batch, 5)
        results.append((metrics, jax_params_from_model(state.model)))
    (m1, p1), (m2, p2) = results
    assert float(m1["loss"]) == float(m2["loss"])
    for key, value in _flat(p1).items():
        np.testing.assert_array_equal(_flat(p2)[key], value, err_msg=key)


def _port_state_after(cfg, params, batches, seed=3):
    state = create_train_state(_model(cfg, params), LR, device="cpu")
    step = make_train_step(_port_cfg(cfg), torch.float32)
    for batch in batches:
        state, _ = step(state, batch, seed)
    return state


def _batches(dataset, n, seed=2):
    batcher = Batcher(dataset, 16, shuffle=True, seed=seed)
    return [b for epoch in range(n) for b in batcher.iter_epoch(epoch)][:n]


def test_a_port_checkpoint_restores_into_a_jax_train_state(corpus,
                                                           tmp_path):
    """Params, Adam's mu, nu and count, the schedule's count and the step
    come back in the JAX layout equal to the bit."""
    train_ds = corpus["port"][0]
    cfg = _jax_cfg(train_ds.num_tokens)
    params = _params(cfg)
    state = _port_state_after(cfg, params, _batches(train_ds, 3))
    path = str(tmp_path / "port.ckpt")
    port_ckpt.save_checkpoint(path, state, epoch=4, model_cfg=_port_cfg(cfg),
                              extra_meta={"max_question_length": 9})
    template = jax_state.create_train_state(
        _params(cfg, seed=7), jax_steps.make_optimizer(LR))
    restored, meta = jax_ckpt.restore_state_meta(template, path)
    assert meta["epoch"] == 4 and meta["max_question_length"] == 9
    assert ModelConfig.from_meta_dict(meta["model_cfg"]) == _port_cfg(cfg)
    assert int(restored.step) == 3
    adam, schedule = restored.opt_state[0], restored.opt_state[1]
    assert int(adam.count) == 3 and int(schedule.count) == 3
    trainable = {n: p for n, p in state.model.named_parameters()
                 if p.requires_grad}
    expected = {
        "params": jax_params_from_model(state.model),
        "mu": jax_tree_from_named({n: state.optimizer.state[p]["exp_avg"]
                                   for n, p in trainable.items()}),
        "nu": jax_tree_from_named({n: state.optimizer.state[p]["exp_avg_sq"]
                                   for n, p in trainable.items()}),
    }
    for name, tree in (("params", restored.params), ("mu", adam.mu),
                       ("nu", adam.nu)):
        got, want = _flat(tree), _flat(expected[name])
        assert got.keys() == want.keys()
        for key, value in want.items():
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert np.abs(_flat(adam.mu)["['text']['lstm_fwd']['b']"]).max() > 0


def test_a_jax_state_takes_its_next_step_in_the_port_as_in_jax(corpus,
                                                                tmp_path):
    """Three JAX steps, saved by the JAX package and restored by the port;
    the fourth step in both. The 50-step test's tolerances: loss 1e-4
    relative, parameter deltas 5e-4 absolute (here one step of LR carries
    far less)."""
    train_ds = corpus["port"][0]
    cfg = _jax_cfg(train_ds.num_tokens)
    params = _params(cfg)
    batches = _batches(train_ds, 4)
    tx = jax_steps.make_optimizer(LR)
    jax_step = jax_steps.make_train_step(cfg, tx, compute_dtype=jnp.float32)
    jstate = jax_state.create_train_state(params, tx)
    rng = jax.random.PRNGKey(0)
    jax_batch = [{k: jnp.asarray(v) for k, v in b.items() if k != "indices"}
                 for b in batches]
    for batch in jax_batch[:3]:
        jstate, _ = jax_step(jstate, batch, rng)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, jstate, epoch=0)
    before = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    jstate, jax_metrics = jax_step(jstate, jax_batch[3], rng)

    state = create_train_state(_model(cfg, _params(cfg, seed=9)), LR,
                               device="cpu")
    state, meta = port_ckpt.restore_state_meta(state, path)
    assert state.step == 3 and meta["epoch"] == 0
    np.testing.assert_array_equal(
        _flat(jax_params_from_model(state.model))
        ["['text']['lstm_fwd']['w_hh']"],
        before["['text']['lstm_fwd']['w_hh']"])
    step = make_train_step(_port_cfg(cfg), torch.float32)
    state, metrics = step(state, batches[3], 0)
    assert state.step == 4
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jax_metrics["loss"]), rtol=1e-4)
    got = _flat(jax_params_from_model(state.model))
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    for key, value in want.items():
        np.testing.assert_allclose(got[key] - before[key],
                                   value - before[key], atol=5e-4, rtol=0,
                                   err_msg=key)
    moved = np.abs(want["['text']['lstm_fwd']['b']"]
                   - before["['text']['lstm_fwd']['b']"]).max()
    assert moved > 0.1 * LR


def _overrides(profile, tmp_path, extra=()):
    return [
        "main.use_full=false",
        f"main.small.paths.base_path={profile['paths']['base_path']}",
        f"main.small.paths.vocab_path={profile['paths']['vocab_path']}",
        f"main.small.paths.logs={tmp_path}/logs/",
        "main.small.train_paths.questions=train_questions.json",
        "main.small.train_paths.answers=train_annotations.json",
        "main.small.val_paths.questions=val_questions.json",
        "main.small.val_paths.answers=val_annotations.json",
        f"main.small.train_paths.processed_imgs="
        f"{profile['train_paths']['processed_imgs']}",
        f"main.small.val_paths.processed_imgs="
        f"{profile['val_paths']['processed_imgs']}",
        f"main.small.train_paths.vqaDataset={tmp_path}/ds_train.npz",
        f"main.small.val_paths.vqaDataset={tmp_path}/ds_val.npz",
        "train.max_answers=12", f"train.image_size={IMAGE}",
        "train.text.question_features=16", "train.text.embedding_features=8",
        "train.image.num_channels=[3, 4, 6]", "train.attention.hidden_dim=12",
        "train.classifier.hidden_dim=16", "tpu.compute_dtype=float32",
        *extra]


def test_the_jax_predictor_serves_a_port_checkpoint(corpus, tmp_path):
    """``predict.py::Predictor`` (JAX) on the port's checkpoint gives the
    port model's probabilities (f32, 1e-5: the same weights, sums in
    another order)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from predict import Predictor as JaxPredictor

    train_ds = corpus["port"][0]
    cfg = _jax_cfg(train_ds.num_tokens)
    state = _port_state_after(cfg, _params(cfg), _batches(train_ds, 2))
    path = str(tmp_path / "served.ckpt")
    port_ckpt.save_checkpoint(
        path, state, epoch=1, model_cfg=_port_cfg(cfg),
        extra_meta={"max_question_length": train_ds.max_question_length})
    profile = corpus["profile"]
    predictor = JaxPredictor(
        jax_config.compose("config", _overrides(profile, tmp_path)), path,
        profile["paths"]["vocab_path"])
    assert predictor.max_question_length == train_ds.max_question_length
    rows = np.arange(6)
    images = train_ds.load_images_nhwc(rows, np.float32)
    questions, lengths = train_ds.questions[rows], \
        train_ds.question_lengths[rows]
    got = predictor.forward_probs(images, questions, lengths)
    with torch.no_grad():
        logits = state.model(torch.from_numpy(images),
                             torch.from_numpy(questions),
                             torch.from_numpy(lengths))
    np.testing.assert_allclose(got, torch.softmax(logits, 1).numpy(),
                               atol=1e-5)


def test_a_pth_blob_imports_as_the_jax_package_imports_it(corpus, tmp_path):
    from dl_vqa_tpu.utils.torch_export import torch_state_from_params

    cfg = _jax_cfg(corpus["port"][0].num_tokens)
    params = _params(cfg, seed=3)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             torch_state_from_params(params).items()}
    state["text.lstm.bias_hh_l0_reverse"] += 0.125
    path = str(tmp_path / "model.pth")
    torch.save({"epoch": 2, "model_state": state, "optimizer_state": {}},
               path)
    got, meta = port_ckpt.load_params(path, with_meta=True)
    want = jax_ckpt.load_params(path, _params(cfg))
    assert meta == {}
    flat_got, flat_want = _flat(got), _flat(want)
    assert flat_got.keys() == flat_want.keys()
    for key, value in flat_want.items():
        np.testing.assert_array_equal(flat_got[key], value, err_msg=key)


def _last(exp_dir):
    with np.load(os.path.join(exp_dir, "last.ckpt")) as data:
        return {k: data[k] for k in data.files}


def test_both_train_loops_agree_from_one_initial_state(corpus, tmp_path):
    """``train()`` of both packages, 2 epochs at dropout 0 in f32, the same
    batches (batch 16, shuffled, a padded last batch) from the same
    parameters. Per-epoch train loss 1e-4 relative; train and validation
    scores and ``Metrics/BestAccuracy`` 1e-4 absolute (percent); the final
    parameters as the 50-step test holds them (5e-4 absolute on the
    deltas; six steps here)."""
    (port_train, port_val), (jax_train, jax_val) = corpus["port"], \
        corpus["jax"]
    cfg = _jax_cfg(port_train.num_tokens)
    params = _params(cfg)
    port_log = _Logger(str(tmp_path / "port"), port_ckpt.save_checkpoint)
    jax_log = _Logger(str(tmp_path / "jax"), jax_ckpt.save_checkpoint)
    port_metrics = port_loop.train(
        _port_cfg(cfg), _model(cfg, params),
        Batcher(port_train, 16, shuffle=True, seed=1),
        Batcher(port_val, 16), _train_params(), port_log,
        compute_dtype=torch.float32, seed=1, checkpoint_every_steps=2)
    jax_metrics = jax_loop.train(
        cfg, params, JaxBatcher(jax_train, 16, shuffle=True, seed=1),
        JaxBatcher(jax_val, 16), _train_params(), jax_log,
        compute_dtype=jnp.float32, seed=1, checkpoint_every_steps=2)
    jax_ckpt.wait_for_async_saves()
    assert port_metrics.keys() == jax_metrics.keys()
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(port_metrics[key], value, atol=1e-4,
                                   rtol=1e-4 if "Loss" in key else 0,
                                   err_msg=key)
    for tag in ("Loss/Train", "Loss/Validation"):
        np.testing.assert_allclose(port_log.scalars[tag],
                                   jax_log.scalars[tag], rtol=1e-4,
                                   err_msg=tag)
    for tag in ("Accuracy/Train", "Accuracy/Validation"):
        np.testing.assert_allclose(port_log.scalars[tag],
                                   jax_log.scalars[tag], atol=1e-4,
                                   err_msg=tag)
    assert port_log.saves == jax_log.saves
    port_last, jax_last = _last(port_log.exp_dir), _last(jax_log.exp_dir)
    assert port_last.keys() == jax_last.keys()
    assert int(port_last["step"]) == int(jax_last["step"]) == 6
    start = {"params|" + k.replace("']['", "|")[2:-2]: v
             for k, v in _flat(params).items()}
    for key, start_value in start.items():
        np.testing.assert_allclose(port_last[key] - start_value,
                                   jax_last[key] - start_value, atol=5e-4,
                                   rtol=0, err_msg=key)


class _CrashingBatcher(Batcher):
    """Raises where it would yield batch ``crash_at[1]`` of epoch
    ``crash_at[0]``."""

    def __init__(self, *args, crash_at=(1, 5), **kwargs):
        super().__init__(*args, **kwargs)
        self.crash_at = crash_at

    def iter_epoch(self, epoch, start_batch=0):
        for i, batch in enumerate(super().iter_epoch(epoch, start_batch)):
            if (epoch, start_batch + i) == self.crash_at:
                raise RuntimeError("the host went away")
            yield batch


def _port_run(corpus, cfg, params, exp_dir, batcher_cls=Batcher,
              table=False, batch_size=16, **kwargs):
    """``params`` is a JAX tree, or an int: the seed of the port's own
    initial weights (torch's draws, two LSTM biases)."""
    train_ds, val_ds = corpus["port"]
    if isinstance(params, int):
        model = VqaNet(_port_cfg(cfg), device="cpu",
                       generator=torch.Generator().manual_seed(params))
    else:
        model = _model(cfg, params)
    tables = ({"train_image_table":
               torch.from_numpy(train_ds.features_nhwc_all()),
               "eval_image_table":
               torch.from_numpy(val_ds.features_nhwc_all())}
              if table else {})
    logger = _Logger(exp_dir, port_ckpt.save_checkpoint)
    metrics = port_loop.train(
        _port_cfg(cfg), model,
        batcher_cls(train_ds, batch_size, shuffle=True, seed=1,
                    load_images=not table),
        Batcher(val_ds, batch_size, load_images=not table), _train_params(),
        logger,
        compute_dtype=torch.float32, seed=1, checkpoint_every_steps=2,
        **tables, **kwargs)
    return metrics, logger


def test_a_mid_epoch_crash_resumes_to_the_uninterrupted_run(corpus,
                                                             tmp_path):
    """Dropout 0.3, the device image table, batch 8 (six batches an epoch,
    the last padded), a save every 2 batches, the port's own initial
    weights (whose two LSTM biases the checkpoint stores as one): the run
    that crashes after batch 5 of epoch 1 and resumes from its last save
    (batch 4) ends with the uninterrupted run's parameters, Adam moments,
    step and metrics, to the bit."""
    cfg = _jax_cfg(corpus["port"][0].num_tokens, dropout=0.3)
    params = 4  # the seed of VqaNet's initial weights
    straight, straight_log = _port_run(corpus, cfg, params,
                                       str(tmp_path / "a"), table=True,
                                       batch_size=8)
    with pytest.raises(RuntimeError, match="went away"):
        _port_run(corpus, cfg, params, str(tmp_path / "b"),
                  batcher_cls=_CrashingBatcher, table=True, batch_size=8)
    crashed = _last(str(tmp_path / "b"))
    assert int(crashed["step"]) == 6 + 4
    resumed, resumed_log = _port_run(
        corpus, cfg, 8, str(tmp_path / "c"), table=True,
        batch_size=8, opt_restore_path=str(tmp_path / "b" / "last.ckpt"))
    assert any("Resuming at epoch 1, batch 4" in ln
               for ln in resumed_log.lines)
    assert resumed == straight
    assert resumed_log.scalars["Loss/Train"] == \
        straight_log.scalars["Loss/Train"][1:]
    a, c = _last(str(tmp_path / "a")), _last(str(tmp_path / "c"))
    assert a.keys() == c.keys()
    for key in a:
        np.testing.assert_array_equal(c[key], a[key], err_msg=key)


@pytest.mark.parametrize("variant", ["san", "transformer_co"])
def test_a_variant_run_resumes_mid_epoch_to_the_bit(corpus, tmp_path,
                                                    variant):
    """The same crash and resume for the two variant presets' models (SAN:
    stacked attention; transformer_co: the transformer question encoder,
    whose blocks the checkpoint holds as a list, with co-attention), the
    port's own initial weights, dropout 0.3: Adam, the LR law and the
    resume cover their parameters, to the bit."""
    cfg = _jax_cfg(corpus["port"][0].num_tokens, dropout=0.3)
    if variant == "san":
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, variant="stacked"))
    else:
        cfg = dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, encoder="transformer",
                                          num_heads=4, num_layers=2),
            attention=dataclasses.replace(cfg.attention, variant="co"))
    straight, _ = _port_run(corpus, cfg, 4, str(tmp_path / "a"), table=True,
                            batch_size=8)
    with pytest.raises(RuntimeError, match="went away"):
        _port_run(corpus, cfg, 4, str(tmp_path / "b"),
                  batcher_cls=_CrashingBatcher, table=True, batch_size=8)
    resumed, _ = _port_run(
        corpus, cfg, 8, str(tmp_path / "c"), table=True, batch_size=8,
        opt_restore_path=str(tmp_path / "b" / "last.ckpt"))
    assert resumed == straight
    a, c = _last(str(tmp_path / "a")), _last(str(tmp_path / "c"))
    assert a.keys() == c.keys()
    assert any("|layers|#1|" in key for key in a)
    for key in a:
        np.testing.assert_array_equal(c[key], a[key], err_msg=key)


def test_a_restart_with_its_budget_spent_reports_the_restored_metrics(
        corpus, tmp_path):
    """As ``tests/test_train.py`` pins it for JAX: a completed run's
    restart trains nothing and returns the restored metrics."""
    cfg = _jax_cfg(corpus["port"][0].num_tokens)
    params = _params(cfg)
    first, _ = _port_run(corpus, cfg, params, str(tmp_path / "done"))
    again, log = _port_run(
        corpus, cfg, params, str(tmp_path / "again"),
        opt_restore_path=str(tmp_path / "done" / "last.ckpt"))
    assert again == pytest.approx(first)
    assert any("epoch budget" in ln for ln in log.lines)
    assert not log.scalars  # no epoch ran


def test_a_mid_epoch_cadence_without_save_model_warns(corpus, tmp_path):
    train_ds, val_ds = corpus["port"]
    cfg = _jax_cfg(train_ds.num_tokens)
    logger = _Logger(str(tmp_path / "nosave"))
    port_loop.train(
        _port_cfg(cfg), _model(cfg, _params(cfg)),
        Batcher(train_ds, 16, shuffle=True, seed=1), Batcher(val_ds, 16),
        _train_params(num_epochs=1, save_model=False), logger,
        compute_dtype=torch.float32, checkpoint_every_steps=2)
    assert any("no effect" in ln and "save_model" in ln for ln in logger.lines)
    assert not os.path.exists(os.path.join(logger.exp_dir, "last.ckpt"))
    assert not logger.saves


def test_an_async_save_is_the_state_it_was_given(corpus, tmp_path):
    """The run steps on while the write is in flight; the file holds the
    state of the call, equal to a synchronous save of it."""
    train_ds = corpus["port"][0]
    cfg = _jax_cfg(train_ds.num_tokens)
    batches = _batches(train_ds, 4)
    state = _port_state_after(cfg, _params(cfg), batches[:2])
    sync_path = str(tmp_path / "sync.ckpt")
    async_path = str(tmp_path / "async.ckpt")
    port_ckpt.save_checkpoint(sync_path, state, epoch=0)
    port_ckpt.save_checkpoint_async(async_path, state, epoch=0)
    step = make_train_step(_port_cfg(cfg), torch.float32)
    for batch in batches[2:]:
        state, _ = step(state, batch, 3)
    port_ckpt.wait_for_async_saves()
    with np.load(sync_path) as a, np.load(async_path) as b:
        assert a.files == b.files
        for key in a.files:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        assert int(b["step"]) == 2 and state.step == 4


def test_remat_gives_the_steps_without_it(corpus):
    """Dropout 0.3: the recomputed forward draws the same masks, so the
    parameters after two steps are equal to the bit."""
    train_ds = corpus["port"][0]
    cfg = _jax_cfg(train_ds.num_tokens, dropout=0.3)
    params = _params(cfg)
    batches = _batches(train_ds, 2)
    finals = []
    for remat in (False, True):
        state = create_train_state(_model(cfg, params), LR, device="cpu")
        step = make_train_step(_port_cfg(cfg), torch.float32, remat=remat)
        for batch in batches:
            state, _ = step(state, batch, 11)
        finals.append(_flat(jax_params_from_model(state.model)))
    for key, value in finals[0].items():
        np.testing.assert_array_equal(finals[1][key], value, err_msg=key)


def test_dropout_masks_are_keyed_to_the_seed_and_the_step():
    from dl_vqa_tpu_torch.train.steps import dropout_generator

    def draw(seed, step, micro=None):
        return torch.randint(0, 256, (64,), generator=dropout_generator(
            seed, step, "cpu", micro))

    assert torch.equal(draw(1, 5), draw(1, 5))
    assert torch.equal(draw(1, 5, 2), draw(1, 5, 2))
    for other in ((1, 6), (2, 5), (1, 5, 0), (1, 5, 1)):
        assert not torch.equal(draw(1, 5), draw(*other)), other
    assert not torch.equal(draw(1, 5, 0), draw(1, 5, 1))


def test_a_batcher_without_iter_epoch_is_refused(corpus, tmp_path):
    """The loop resumes into an epoch through ``iter_epoch``: a batcher
    without it is refused before any step."""
    cfg = _jax_cfg(corpus["port"][0].num_tokens)

    class Duck:
        def __init__(self, inner):
            self.inner, self.dataset = inner, inner.dataset

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            return iter(self.inner)

    train_ds, val_ds = corpus["port"]
    with pytest.raises(TypeError, match="iter_epoch"):
        port_loop.train(
            _port_cfg(cfg), _model(cfg, _params(cfg)),
            Duck(Batcher(train_ds, 8, shuffle=True, seed=1)),
            Batcher(val_ds, 8), _train_params(), _Logger(str(tmp_path)),
            compute_dtype=torch.float32)
