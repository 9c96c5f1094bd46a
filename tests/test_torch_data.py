"""The port's data plane against ``dl_vqa_tpu``'s, on the CPU: the config
presets, the dataset and its npz cache, the two image-store containers,
the batcher, the device image table's policy, the prefetcher, and the
numpy corpus. The JAX corpus is ``make_synthetic_corpus`` (JPEGs and h5
caches through PIL and h5py, which the sandbox has); the port reads it
as it is, and an ``.npy`` copy of its stores."""

import json
import os

import numpy as np
import pytest
import torch

from dl_vqa_tpu import config as jax_config
from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu.data.dataset import StaleImageCacheError as JaxStale
from dl_vqa_tpu.data.dataset import VQADataset as JaxDataset
from dl_vqa_tpu.data.pipeline import Batcher as JaxBatcher
from dl_vqa_tpu_torch import config as port_config
from dl_vqa_tpu_torch.data import device_cache
from dl_vqa_tpu_torch.data import synthetic as port_synthetic
from dl_vqa_tpu_torch.data.dataset import (
    StaleImageCacheError,
    VQADataset,
    store_ids,
)
from dl_vqa_tpu_torch.data.pipeline import Batcher, prefetch_to_device

PRESETS = ["config", "config_eval", "config_san", "config_transformer_co",
           "config_vit", "config_vit_moe"]
FIELDS = VQADataset._ARRAY_FIELDS


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_the_yaml_files(name):
    assert port_config.compose(name) == jax_config.compose(name)
    overrides = ["train.batch_size=512", "tpu.device_image_cache=on",
                 "train.lr.lr_value=5e-4", "main.use_full=false"]
    assert port_config.compose(name, overrides) == \
        jax_config.compose(name, overrides)


def test_an_unknown_preset_and_a_bad_override_raise():
    with pytest.raises(ValueError, match="config_nope"):
        port_config.compose("config_nope")
    with pytest.raises(port_config.SchemaError, match="batch_size"):
        port_config.compose("config", ["train.batch_size=big"])


def _npy_copy(h5_path, out_dir):
    """The h5 store's ``features`` and ``ids`` as an ``.npy`` pair."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    with h5py.File(h5_path, "r") as fd:
        np.save(os.path.join(out_dir, "features.npy"), fd["features"][()])
        np.save(os.path.join(out_dir, "ids.npy"), fd["ids"][()])
    return out_dir


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    profile = jax_synthetic.make_synthetic_corpus(
        root, n_train=45, n_val=14, n_images=6, image_size=24,
        max_answers=12, learnable=True)
    for split in ("train_paths", "val_paths"):
        h5 = profile[split]["processed_imgs"]
        profile[split]["npy_imgs"] = _npy_copy(h5, h5[:-len(".h5")])
    return profile


def _datasets(corpus, split, answerable_only, store="processed_imgs"):
    paths = dict(corpus[split], processed_imgs=corpus[split][store])
    return (VQADataset(paths, corpus["paths"],
                       answerable_only=answerable_only),
            JaxDataset(corpus[split], corpus["paths"],
                       answerable_only=answerable_only))


def _assert_same_arrays(got, expected):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(expected, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("vocab", "max_question_length", "answerable_only",
                 "num_tokens", "has_image_rows"):
        assert getattr(got, name) == getattr(expected, name), name


@pytest.mark.parametrize("answerable_only", [True, False])
def test_dataset_arrays_equal_the_jax_dataset(corpus, answerable_only):
    for split in ("train_paths", "val_paths"):
        port, jax_ds = _datasets(corpus, split, answerable_only)
        _assert_same_arrays(port, jax_ds)
        assert port._h5_ids_meta == jax_ds._h5_ids_meta
        assert port.image_store_nbytes == jax_ds.image_store_nbytes
        rows = np.array([3, 0, 3, len(port) - 1])
        np.testing.assert_array_equal(port.load_images_nhwc(rows),
                                      jax_ds.load_images_nhwc(rows))
        np.testing.assert_array_equal(port.features_nhwc_all(),
                                      jax_ds.features_nhwc_all())


def test_each_package_loads_the_others_npz_cache(corpus, tmp_path):
    port, jax_ds = _datasets(corpus, "train_paths", True)
    port.save(str(tmp_path / "port.npz"))
    jax_ds.save(str(tmp_path / "jax"))  # the extension is added
    _assert_same_arrays(JaxDataset.load(str(tmp_path / "port.npz")), jax_ds)
    _assert_same_arrays(VQADataset.load(str(tmp_path / "jax.npz")), port)
    assert VQADataset.cache_path("a/b.pkl") == JaxDataset.cache_path(
        "a/b.pkl") == "a/b.npz"


def test_a_cache_built_against_another_store_is_stale(corpus, tmp_path):
    """Both packages refuse a cached row map whose store changed."""
    import h5py

    port, _ = _datasets(corpus, "train_paths", True)
    path = str(tmp_path / "ds.npz")
    port.save(path)
    with np.load(path) as data:
        arrays = dict(data)
    meta = json.loads(bytes(arrays["meta"]).decode())
    moved = str(tmp_path / "moved.h5")
    with h5py.File(moved, "w") as fd:
        ids = store_ids(corpus["train_paths"]["processed_imgs"])
        fd["ids"] = ids[::-1]
        fd["features"] = np.zeros((len(ids), 3, 2, 2), np.float16)
    meta["image_path"] = moved
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(StaleImageCacheError):
        VQADataset.load(path)
    with pytest.raises(JaxStale):
        JaxDataset.load(path)


def test_the_h5_and_npy_stores_give_equal_batches(corpus):
    h5, _ = _datasets(corpus, "train_paths", True)
    npy, _ = _datasets(corpus, "train_paths", True, store="npy_imgs")
    assert isinstance(npy._features_view(), np.memmap)
    assert isinstance(h5._features_view(), np.memmap)
    np.testing.assert_array_equal(h5.h5_rows, npy.h5_rows)
    for a, b in zip(Batcher(h5, 8, shuffle=True, seed=3).iter_epoch(1),
                    Batcher(npy, 8, shuffle=True, seed=3).iter_epoch(1)):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert npy.image_store_nbytes == h5.image_store_nbytes


def test_an_integer_store_is_refused(corpus, tmp_path):
    store = str(tmp_path / "raw")
    os.makedirs(store)
    ids = store_ids(corpus["val_paths"]["processed_imgs"])
    np.save(os.path.join(store, "ids.npy"), ids)
    np.save(os.path.join(store, "features.npy"),
            np.zeros((len(ids), 3, 4, 4), np.uint8))
    paths = dict(corpus["val_paths"], processed_imgs=store)
    ds = VQADataset(paths, corpus["paths"])
    with pytest.raises(ValueError, match="integer dtype uint8"):
        ds.load_images_nhwc(np.arange(2))


@pytest.mark.parametrize("shuffle,seed,batch_size,start", [
    (True, 7, 16, 0), (True, 7, 16, 2), (False, 0, 8, 1), (True, 1, 45, 0),
    (True, 2, 50, 0)])
@pytest.mark.parametrize("load_images", [True, False], ids=["images", "rows"])
def test_batches_equal_the_jax_batcher(corpus, shuffle, seed, batch_size,
                                       start, load_images):
    """Orders, padding, mask, indices, images or ``image_rows``."""
    port_ds, jax_ds = _datasets(corpus, "train_paths", True)
    port = Batcher(port_ds, batch_size, shuffle=shuffle, seed=seed,
                   load_images=load_images)
    jax_b = JaxBatcher(jax_ds, batch_size, shuffle=shuffle, seed=seed,
                       load_images=load_images)
    assert len(port) == len(jax_b)
    for epoch in (0, 3):
        np.testing.assert_array_equal(port.epoch_order(epoch),
                                      jax_b.epoch_order(epoch))
        got = list(port.iter_epoch(epoch, start))
        expected = list(jax_b.iter_epoch(epoch, start))
        assert len(got) == len(expected) == len(port) - start
        for a, b in zip(got, expected):
            assert a.keys() == b.keys()
            assert ("images" in a) == load_images
            assert ("image_rows" in a) == (not load_images)
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # __iter__'s k-th pass is iter_epoch(k).
    for k in range(2):
        for a, b in zip(iter(port), port.iter_epoch(k)):
            np.testing.assert_array_equal(a["indices"], b["indices"])
    # A process's rows of each global batch (the multi-process tier), the
    # padded batch's mask sliced with them, as the JAX Batcher gives them.
    rows = slice(batch_size // 2, batch_size)
    sliced = Batcher(port_ds, batch_size, shuffle=shuffle, seed=seed,
                     load_images=load_images, process_slice=rows)
    jax_sliced = JaxBatcher(jax_ds, batch_size, shuffle=shuffle, seed=seed,
                            load_images=load_images, process_slice=rows)
    for a, b, whole in zip(sliced.iter_epoch(3, start),
                           jax_sliced.iter_epoch(3, start),
                           port.iter_epoch(3, start)):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            np.testing.assert_array_equal(a[key], whole[key][rows],
                                          err_msg=key)


def _cfg(mode, budget_gb=0, layout="replicated"):
    return {"tpu": {"device_image_cache": mode,
                    "device_image_cache_budget_gb": budget_gb,
                    "device_image_cache_layout": layout}}


def test_device_table_policy(corpus):
    train, _ = _datasets(corpus, "train_paths", True)
    val, _ = _datasets(corpus, "val_paths", False)
    same = VQADataset(corpus["val_paths"], corpus["paths"])
    assert [device_cache.cache_mode(_cfg(m)) for m in
            (True, False, "auto", "on", "off")] == \
        ["on", "off", "auto", "on", "off"]
    with pytest.raises(ValueError):
        device_cache.cache_mode(_cfg("sometimes"))
    sets = {"train": train, "val": val, "again": same}
    tables = device_cache.plan_image_tables(_cfg("auto"), sets, "cpu")
    assert tables["val"] is tables["again"]  # one upload a store
    assert tables["train"].dtype == torch.float16
    np.testing.assert_array_equal(tables["train"].numpy(),
                                  train.features_nhwc_all())
    lines = []
    tiny = device_cache.plan_image_tables(_cfg("auto", 1e-6), sets, "cpu",
                                          log=lines.append)
    assert all(t is None for t in tiny.values()) and "budget" in lines[0]
    forced = device_cache.plan_image_tables(_cfg("on", 1e-6), sets, "cpu")
    assert forced["train"] is not None
    assert all(t is None for t in device_cache.plan_image_tables(
        _cfg(False), sets, "cpu").values())
    # 'sharded' over one 'data' shard (no mesh, or a mesh of one) is the
    # replicated layout, as in the JAX package.
    from dl_vqa_tpu_torch.parallel import make_mesh

    for mesh in (None, make_mesh(-1, device_type="cpu")):
        sharded = device_cache.plan_image_tables(
            _cfg("on", layout="sharded"), sets, "cpu", mesh=mesh)
        assert torch.equal(sharded["train"], tables["train"])
    with pytest.raises(ValueError, match="layout"):
        device_cache.plan_image_tables(_cfg("on", layout="striped"), sets,
                                       "cpu")
    with pytest.raises(ValueError, match="budget_gb"):
        device_cache.plan_image_tables(_cfg("auto", -1), sets, "cpu")


def test_prefetch_delivers_in_order_and_stops(corpus):
    ds, _ = _datasets(corpus, "train_paths", True)
    batcher = Batcher(ds, 8, shuffle=True, seed=5)
    for depth in (0, 1, 3):
        got = list(prefetch_to_device(batcher.iter_epoch(2), "cpu", depth))
        expected = list(batcher.iter_epoch(2))
        assert len(got) == len(expected)
        for a, b in zip(got, expected):
            for key in b:
                assert isinstance(a[key], torch.Tensor)
                np.testing.assert_array_equal(a[key].numpy(), b[key])

    def failing():
        yield from batcher.iter_epoch(0)
        raise RuntimeError("loader failed")

    with pytest.raises(RuntimeError, match="loader failed"):
        list(prefetch_to_device(failing(), "cpu", 2))
    produced = []

    def counting():
        for batch in batcher.iter_epoch(0):
            produced.append(1)
            yield batch

    stream = prefetch_to_device(counting(), "cpu", 1)
    next(stream)
    stream.close()  # the consumer stops: the producer must stop too
    assert len(produced) <= 3


def test_numpy_corpus_has_the_jax_corpus_questions(corpus, tmp_path):
    """The port's corpus maker writes the JSONs and vocab the JAX one
    writes for the same arguments, and its ``.npy`` store renders the
    attributes the answers ask about."""
    root = str(tmp_path / "port")
    profile = port_synthetic.make_synthetic_corpus(
        root, n_train=45, n_val=14, n_images=6, image_size=24,
        max_answers=12, learnable=True)
    jax_root = corpus["paths"]["base_path"]
    for name in ("train_questions.json", "train_annotations.json",
                 "val_questions.json", "val_annotations.json", "vocab.json"):
        with open(os.path.join(root, name)) as a, \
                open(os.path.join(jax_root, name)) as b:
            assert json.load(a) == json.load(b), name
    ds = VQADataset(profile["train_paths"], profile["paths"],
                    answerable_only=True)
    assert isinstance(ds._features_view(), np.memmap)
    ids = store_ids(profile["train_paths"]["processed_imgs"]).tolist()
    assert ids == sorted(set(ds.image_ids.tolist()) | set(ids))
    u8 = port_synthetic.render_images(ids, 24, learnable=True)
    store = np.load(os.path.join(profile["train_paths"]["processed_imgs"],
                                 "features.npy"))
    np.testing.assert_array_equal(
        store, port_synthetic.normalize_uint8_chw(u8).astype(np.float16))
    for row, img_id in enumerate(ids):
        attrs = port_synthetic._image_attrs(img_id, 0)
        base = np.array(port_synthetic._COLOR_RGB[attrs["color"]])
        # The corner holds no square: its level over the color's is the
        # brightness the yes/no answer asks about (1 or 0.45).
        level = u8[row, :4, :4].astype(np.float32).mean() / base.mean()
        assert (level > 0.72) == attrs["bright"], (img_id, attrs, level)
    rng = np.random.default_rng(0)
    halves = np.concatenate([
        port_synthetic.render_images(ids[:2], 24, learnable=True, rng=rng),
        port_synthetic.render_images(ids[2:], 24, learnable=True, rng=rng)])
    np.testing.assert_array_equal(u8, halves)


def test_widened_questions_give_the_asked_vocab_and_length(tmp_path):
    """``question_tokens`` / ``question_length`` pad every question with
    filler words in front of its own text: the train vocab has the asked
    size, the longest question of each split the asked length, and the
    answers and images stay those of the plain corpus."""
    plain = port_synthetic.make_synthetic_corpus(
        str(tmp_path / "plain"), n_train=40, n_val=12, n_images=6,
        image_size=8, learnable=True)
    wide = port_synthetic.make_synthetic_corpus(
        str(tmp_path / "wide"), n_train=40, n_val=12, n_images=6,
        image_size=8, learnable=True, question_tokens=120,
        question_length=9)
    for split in ("train", "val"):
        a, b = (VQADataset(p[f"{split}_paths"], p["paths"])
                for p in (plain, wide))
        assert b.max_question_length == 9 and a.max_question_length < 9
        for name in ("answer_indices", "answer_values", "answer_types",
                     "image_ids", "question_ids", "h5_rows"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        with open(os.path.join(plain["paths"]["base_path"],
                               f"{split}_questions.json")) as fd:
            before = json.load(fd)["questions"]
        with open(os.path.join(wide["paths"]["base_path"],
                               f"{split}_questions.json")) as fd:
            after = json.load(fd)["questions"]
        for q0, q1 in zip(before, after):
            head = q1["question"][:-len(q0["question"])].split()
            assert q1["question"].endswith(q0["question"])
            assert all(w.startswith("zq") for w in head)
        if split == "train":
            assert b.num_tokens == 120
    with pytest.raises(ValueError, match="cannot hold"):
        port_synthetic.make_synthetic_corpus(
            str(tmp_path / "small"), n_train=10, n_val=4, n_images=2,
            image_size=8, learnable=True, question_tokens=500,
            question_length=9)
