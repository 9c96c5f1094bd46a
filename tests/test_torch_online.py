"""The port's online JPEG pipeline (``dl_vqa_tpu_torch.data.online``) and
the loop's ``profile_dir`` and ``debug_nans`` against the JAX package, on
the CPU at 64 px: the loader against ``NativeJpegLoader`` and the PIL
``JpegLoader``, ``OnlineBatcher`` against the JAX one, eval online against
eval from the store and against the JAX package's online eval, the entry
points with ``tpu.online_images`` and ``tpu.native_loader`` against the
JAX entry points, a missing store built from the JPEGs, the epoch-1 trace,
and ``FloatingPointError`` on a store with a NaN row in both packages."""

import dataclasses
import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dl_vqa_tpu import config as jax_config
from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu.data.dataset import VQADataset as JaxDataset
from dl_vqa_tpu.data.native_loader import NativeJpegLoader
from dl_vqa_tpu.data.online import JpegLoader as JaxJpegLoader
from dl_vqa_tpu.data.online import OnlineBatcher as JaxOnlineBatcher
from dl_vqa_tpu_torch import config as port_config
from dl_vqa_tpu_torch import evaluate_vqa as port_eval
from dl_vqa_tpu_torch import main as port_main
from dl_vqa_tpu_torch.data.dataset import VQADataset as PortDataset
from dl_vqa_tpu_torch.data.online import JpegLoader, OnlineBatcher
from dl_vqa_tpu_torch.data.pipeline import Batcher
from dl_vqa_tpu_torch.train.loop import EPOCH_SPAN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
FRACTION = 0.875


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("online_corpus"))
    return jax_synthetic.make_synthetic_corpus(
        root, n_train=40, n_val=24, n_images=6, image_size=SIZE,
        max_answers=12, learnable=True)


def _image_dir(corpus, split="val_paths"):
    return os.path.join(corpus["paths"]["base_path"], corpus[split]["imgs"])


def _overrides(corpus, tmp_path, store=True):
    out = [
        "main.use_full=false",
        f"main.small.paths.base_path={corpus['paths']['base_path']}",
        f"main.small.paths.vocab_path={tmp_path}/vocab.json",
        f"main.small.paths.logs={tmp_path}/logs/",
        "main.small.train_paths.questions=train_questions.json",
        "main.small.train_paths.answers=train_annotations.json",
        "main.small.val_paths.questions=val_questions.json",
        "main.small.val_paths.answers=val_annotations.json",
        f"main.small.train_paths.vqaDataset={tmp_path}/ds_train.npz",
        f"main.small.val_paths.vqaDataset={tmp_path}/ds_val.npz",
        "main.num_workers=3",
        "train.num_epochs=2", "train.batch_size=16", "train.max_answers=12",
        f"train.image_size={SIZE}", "train.text.question_features=16",
        "train.text.embedding_features=8",
        "train.image.num_channels=[3, 4, 6]", "train.attention.hidden_dim=12",
        "train.classifier.hidden_dim=16", "tpu.compute_dtype=float32",
    ]
    for split in ("train_paths", "val_paths"):
        path = (corpus[split]["processed_imgs"] if store
                else f"{tmp_path}/{split}_store.h5")
        out.append(f"main.small.{split}.processed_imgs={path}")
    return out


def _eval_overrides(overrides, exp_dir):
    return overrides + [
        f"main.small.paths.pretrained_model_path={exp_dir}/model.ckpt",
        "train.image.stride=1", "train.attention.do_option=+"]


def _jax_eval(overrides):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import evaluate_vqa as jax_eval

    return jax_eval.evaluate_hw2(overrides)


def test_loader_equals_the_native_loader_and_is_a_level_from_pil(corpus):
    image_dir = _image_dir(corpus)
    ids = np.array([1003, 1000, 1005, 1000, 1001, 1004, 1002, 1003])
    loader = JpegLoader(image_dir, SIZE, FRACTION, num_threads=1,
                        device="cpu")
    assert loader.decoder == "libjpeg"
    got = loader.load_batch(ids)
    assert got.dtype == np.uint8 and got.shape == (len(ids), SIZE, SIZE, 3)
    np.testing.assert_array_equal(
        got, NativeJpegLoader(image_dir, SIZE, FRACTION).load_batch(ids))
    np.testing.assert_array_equal(
        JpegLoader(image_dir, SIZE, FRACTION, num_threads=4,
                   decoder="libjpeg").load_batch(ids), got)
    pil = JaxJpegLoader(image_dir, SIZE, FRACTION).load_batch(ids)
    assert np.abs(got.astype(int) - pil).max() <= 1
    with pytest.raises(KeyError, match="image id 77"):
        loader.load_batch(np.array([77]))


@pytest.mark.parametrize("split,shuffle", [("train_paths", True),
                                           ("val_paths", False)],
                         ids=["train_shuffled", "val"])
def test_online_batches_equal_the_jax_online_batcher(corpus, split,
                                                     shuffle):
    """Two epochs of 5-sample batches (the last padded): every array
    equal to the JAX OnlineBatcher's, the images those of its native
    loader to the bit and of its PIL loader within a level; no sample
    indices and no image rows."""
    image_dir = _image_dir(corpus, split)
    kw = dict(data_paths=corpus[split], other_paths=corpus["paths"],
              answerable_only=shuffle, require_image_cache=False)
    port = OnlineBatcher(PortDataset(**kw), 5,
                         JpegLoader(image_dir, SIZE, FRACTION, 3,
                                    device="cpu"), shuffle=shuffle, seed=3)
    jax_ds = JaxDataset(**kw)
    native = JaxOnlineBatcher(jax_ds, 5, NativeJpegLoader(
        image_dir, SIZE, FRACTION), shuffle=shuffle, seed=3)
    pil = JaxOnlineBatcher(jax_ds, 5, JaxJpegLoader(image_dir, SIZE,
                                                    FRACTION),
                           shuffle=shuffle, seed=3)
    assert len(port) == len(native)
    for epoch in (0, 1):
        batches = list(port.iter_epoch(epoch))
        assert len(batches) == len(port)
        for got, want, near in zip(batches, native.iter_epoch(epoch),
                                   pil.iter_epoch(epoch)):
            assert sorted(got) == sorted(want)
            assert "indices" not in got and "image_rows" not in got
            for key, value in want.items():
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            assert got["images"].dtype == np.uint8
            assert np.abs(got["images"].astype(int)
                          - near["images"]).max() <= 1


def test_a_dataset_without_the_store_has_no_rows(corpus, tmp_path):
    paths = dict(corpus["val_paths"],
                 processed_imgs=str(tmp_path / "absent.h5"))
    ds = PortDataset(data_paths=paths, other_paths=corpus["paths"],
                     require_image_cache=False)
    assert not ds.has_image_rows and ds.image_store_nbytes == 0
    np.testing.assert_array_equal(ds.h5_rows, np.zeros(len(ds)))
    with pytest.raises(RuntimeError, match="no row map"):
        ds.load_images_nhwc(np.arange(2))
    ds.save(str(tmp_path / "ds.npz"))
    for cls in (PortDataset, JaxDataset):
        loaded = cls.load(str(tmp_path / "ds.npz"))
        assert not loaded.has_image_rows
        np.testing.assert_array_equal(loaded.questions, ds.questions)


def test_online_eval_equals_store_eval_and_the_jax_online_eval(corpus):
    """One model, f32: the eval pass on decoded JPEGs and on the fp16
    store, and the JAX package's on its native loader's JPEGs: the same
    score (1e-6) and losses within the store's fp16 rounding (1e-3)."""
    from dl_vqa_tpu.models import ModelConfig as JaxModelConfig
    from dl_vqa_tpu.models import vqa
    from dl_vqa_tpu.models.configs import (
        AttentionConfig, ClassifierConfig, ImageConfig, TextConfig)
    from dl_vqa_tpu.train import make_eval_step as jax_eval_step
    from dl_vqa_tpu.train.loop import evaluate as jax_evaluate
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import make_eval_step
    from dl_vqa_tpu_torch.train.loop import evaluate
    from dl_vqa_tpu_torch.utils.params import load_jax_params

    kw = dict(data_paths=corpus["val_paths"], other_paths=corpus["paths"])
    val = PortDataset(**kw)
    cfg = JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=0.0),
        image=ImageConfig(num_channels=(3, 4, 6), dropout=0.0),
        attention=AttentionConfig(hidden_dim=12, glimpses=2, dropout=0.0),
        classifier=ClassifierConfig(hidden_dim=16, dropout=0.0),
        max_answers=len(val.answer_vocab), image_size=SIZE,
        num_tokens=val.num_tokens)
    params = vqa.init(jax.random.PRNGKey(1), cfg)
    model_cfg = ModelConfig.from_meta_dict(dataclasses.asdict(cfg))
    model = load_jax_params(VqaNet(model_cfg, device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    step = make_eval_step(model_cfg, torch.float32)
    image_dir = _image_dir(corpus)
    loader = JpegLoader(image_dir, SIZE, FRACTION, 2, device="cpu")
    score_on, loss_on = evaluate(step, model, OnlineBatcher(val, 4, loader))
    score_off, loss_off = evaluate(step, model, Batcher(val, 4))
    jax_val = JaxDataset(**kw, require_image_cache=False)
    jax_score, jax_loss = jax_evaluate(
        jax_eval_step(cfg, compute_dtype=jnp.float32), params,
        JaxOnlineBatcher(jax_val, 4, NativeJpegLoader(image_dir, SIZE,
                                                      FRACTION)))
    assert score_on == pytest.approx(score_off, abs=1e-6)
    assert loss_on == pytest.approx(loss_off, abs=1e-3)
    assert score_on == pytest.approx(jax_score, abs=1e-6)
    assert loss_on == pytest.approx(jax_loss, abs=1e-5)


@pytest.fixture(scope="module")
def online_run(corpus, tmp_path_factory):
    """The port's ``main`` online for 2 epochs with ``tpu.profile_dir``:
    the overrides, the best score, the experiment dir and its log."""
    tmp_path = tmp_path_factory.mktemp("online_run")
    overrides = _overrides(corpus, tmp_path, store=False) + [
        "tpu.online_images=true"]
    best = port_main.main(port_config.compose(
        "config", overrides + [f"tpu.profile_dir={tmp_path}/trace"]),
        device="cpu")
    (exp_dir,) = glob.glob(str(tmp_path / "logs" / "final_model_*"))
    return {"overrides": overrides, "best": best, "exp_dir": exp_dir,
            "tmp": tmp_path}


def test_online_main_builds_no_store_and_traces_epoch_one(online_run):
    """No store is built in online mode; two epochs write one Chrome
    trace, of epoch 1's train pass, into ``profile_dir``."""
    tmp = online_run["tmp"]
    assert not glob.glob(str(tmp / "*_store.h5"))
    assert 0.0 <= online_run["best"] <= 100.0
    traces = os.listdir(tmp / "trace")
    assert len(traces) == 1 and traces[0].startswith("epoch1_")
    assert traces[0].endswith(".pt.trace.json")
    with open(tmp / "trace" / traces[0]) as fd:
        events = json.load(fd)["traceEvents"]
    assert sum(e.get("name") == EPOCH_SPAN for e in events) == 1
    (log,) = glob.glob(os.path.join(online_run["exp_dir"], "*.log"))
    with open(log) as fd:
        text = fd.read()
    assert f"Profiler trace written to {tmp / 'trace'}" in text
    assert "by libjpeg on 3 threads" in text


def test_one_epoch_writes_no_trace(corpus, tmp_path):
    overrides = _overrides(corpus, tmp_path) + [
        "train.num_epochs=1", "train.save_model=false",
        f"tpu.profile_dir={tmp_path}/trace"]
    port_main.main(port_config.compose("config", overrides), device="cpu")
    assert not os.path.exists(tmp_path / "trace")


@pytest.mark.parametrize("flag", ["online_images", "native_loader"])
def test_online_entry_points_give_the_jax_evaluation_score(
        corpus, online_run, tmp_path, flag):
    """The best checkpoint of an online run scored online by the port's
    ``evaluate_vqa``: the loop's best score, and the JAX entry point's
    score with the same settings (its PIL loader within a level, its native
    loader to the bit; no sample of this corpus sits that close to a
    tie)."""
    if flag == "online_images":
        overrides, best = online_run["overrides"], online_run["best"]
        exp_dir = online_run["exp_dir"]
    else:
        overrides = _overrides(corpus, tmp_path, store=False) + [
            "tpu.online_images=true", "tpu.native_loader=true"]
        best = port_main.main(port_config.compose("config", overrides),
                              device="cpu")
        (exp_dir,) = glob.glob(str(tmp_path / "logs" / "final_model_*"))
    eval_overrides = _eval_overrides(overrides, exp_dir)
    score = port_eval.evaluate_hw2(eval_overrides, device="cpu")
    assert score == round(best, 3)
    assert _jax_eval(eval_overrides) == score


def test_a_missing_store_is_built_from_the_jpegs(corpus, tmp_path):
    """``main`` builds both missing stores (h5 here): the ids of the JAX
    corpus's stores, their PIL-built features within 0.02 (one level plus
    fp16 rounding); ``evaluate_vqa`` builds the missing val store again and
    scores the loop's best."""
    overrides = _overrides(corpus, tmp_path, store=False) + [
        "train.num_epochs=1", "tpu.image_builder_backend=native"]
    best = port_main.main(port_config.compose("config", overrides),
                          device="cpu")
    import h5py

    for split in ("train_paths", "val_paths"):
        with h5py.File(f"{tmp_path}/{split}_store.h5", "r") as got, \
                h5py.File(corpus[split]["processed_imgs"], "r") as jax_h5:
            np.testing.assert_array_equal(got["ids"][()], jax_h5["ids"][()])
            err = np.abs(got["features"][()].astype(np.float32)
                         - jax_h5["features"][()].astype(np.float32)).max()
            assert err <= 0.02
    (exp_dir,) = glob.glob(str(tmp_path / "logs" / "final_model_*"))
    os.remove(f"{tmp_path}/val_paths_store.h5")
    os.remove(f"{tmp_path}/ds_val.npz")
    score = port_eval.evaluate_hw2(_eval_overrides(overrides, exp_dir),
                                   device="cpu")
    assert score == round(best, 3)
    assert os.path.exists(f"{tmp_path}/val_paths_store.h5")


def test_int8_calibration_online_without_a_train_store_raises(online_run):
    overrides = _eval_overrides(online_run["overrides"],
                                online_run["exp_dir"]) + [
        "train.image.store_dtype=int8"]
    with pytest.raises(ValueError, match="auto-calibration"):
        port_eval.evaluate_hw2(overrides, device="cpu")


@pytest.fixture
def nan_store(corpus, tmp_path):
    """The overrides of a run on a copy of the train store whose row of
    the most asked-about image is NaN."""
    import h5py

    store = str(tmp_path / "train_nan.h5")
    shutil.copyfile(corpus["train_paths"]["processed_imgs"], store)
    ds = PortDataset(data_paths=corpus["train_paths"],
                     other_paths=corpus["paths"])
    row = int(np.bincount(ds.h5_rows).argmax())
    with h5py.File(store, "r+") as fd:
        feats = fd["features"]
        feats[row] = np.full(feats.shape[1:], np.nan, np.float16)
    return _overrides(corpus, tmp_path) + [
        f"main.small.train_paths.processed_imgs={store}",
        "train.num_epochs=1", "train.save_model=false",
        "tpu.debug_nans=true"]


def test_a_nan_row_raises_floating_point_error_in_both_packages(nan_store):
    with pytest.raises(FloatingPointError, match="train step 0"):
        port_main.main(port_config.compose("config", nan_store),
                       device="cpu")
    assert not torch.is_anomaly_enabled()
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import main as jax_main

    try:
        with pytest.raises(FloatingPointError):
            jax_main.main(jax_config.compose("config", nan_store))
    finally:
        jax.config.update("jax_debug_nans", False)


def test_a_clean_run_gives_the_same_metric_with_and_without_the_flag(
        corpus, tmp_path):
    overrides = _overrides(corpus, tmp_path) + [
        "train.num_epochs=1", "train.save_model=false",
        "tpu.online_images=true"]
    plain = port_main.main(port_config.compose("config", overrides),
                           device="cpu")
    checked = port_main.main(port_config.compose(
        "config", overrides + ["tpu.debug_nans=true"]), device="cpu")
    assert checked == plain
    assert not torch.is_anomaly_enabled()
