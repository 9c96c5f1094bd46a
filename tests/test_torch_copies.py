"""The port imports nothing of ``dl_vqa_tpu``; what it needs from that
package's JAX-free modules it keeps as copies. Each copy is held to its
original here (this file may import both), and the sources are searched
for an import of the JAX package."""

import dataclasses
import glob
import os
import re

import numpy as np
import pytest

import jax
import torch

from dl_vqa_tpu.config import core as jax_config_core
from dl_vqa_tpu.config import schema as jax_schema
from dl_vqa_tpu.data import dataset as jax_dataset
from dl_vqa_tpu.data import images as jax_images
from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu.data import text as jax_text
from dl_vqa_tpu.data import vocab as jax_vocab
from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig,
    ClassifierConfig,
    ImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig,
)
from dl_vqa_tpu.utils import torch_export
from dl_vqa_tpu.utils import torch_import as jax_torch_import
from dl_vqa_tpu_torch.config import core as port_config_core
from dl_vqa_tpu_torch.config import schema as port_schema
from dl_vqa_tpu_torch.data import images as port_images
from dl_vqa_tpu_torch.data import synthetic as port_synthetic
from dl_vqa_tpu_torch.data import text as port_text
from dl_vqa_tpu_torch.data import vocab as port_vocab
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.utils import params as port_params
from dl_vqa_tpu_torch.utils import torch_import as port_torch_import

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

AWKWARD = [
    "What color is the dog?",
    "how  many   people?",          # runs of spaces give empty tokens
    "?",
    " is it?",
    "Is THIS a man's hat, or a woman's?",
    "what's 2+2?",
    "qué es esto?",
    "tab\there?",
    "a b c d e f g h i j k l m n o p q r s t u v w x y z?",
    "ends with two??",
]
VOCAB = {w: i + 1 for i, w in enumerate(
    ["what", "color", "is", "the", "dog", "how", "many", "people", "", "a",
     "it", "this", "man's", "hat,", "b", "c", "2+2", "esto", "ends"])}


@pytest.mark.parametrize("question", AWKWARD)
def test_tokenizer_and_encoder_copies_match_the_originals(question):
    tokens = port_text.normalize_question(question)
    assert tokens == jax_text.normalize_question(question)
    for max_len in (len(tokens), len(tokens) + 3):
        got = port_text.encode_question(tokens[:max_len], VOCAB, max_len)
        expected = jax_dataset.encode_question(tokens[:max_len], VOCAB,
                                               max_len)
        np.testing.assert_array_equal(got[0], expected[0])
        assert got[0].dtype == expected[0].dtype and got[1] == expected[1]


def test_a_question_without_its_mark_raises_as_the_original_does():
    for fn in (port_text.normalize_question, jax_text.normalize_question):
        with pytest.raises(ValueError, match=r"end with '\?'"):
            fn("no mark")


def test_image_constants_match_the_originals():
    for name in ("IMAGENET_MEAN", "IMAGENET_STD"):
        got, expected = getattr(port_images, name), getattr(jax_images, name)
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("filename", [
    "COCO_train2014_000000000123.jpg", "COCO_val2014_000000581929.jpg",
    "x_7.jpg", "COCO_test2015_000000000001.jpeg.jpg"])
def test_coco_id_copy_matches_the_original(filename):
    assert port_images.coco_id_from_filename(filename) == \
        jax_images.coco_id_from_filename(filename)


def test_list_jpgs_copy_matches_the_original(tmp_path):
    for name in ("COCO_val2014_000000000001.jpg", "b.jpeg", "c.JPG",
                 "d.jpg.txt", "e.png", "COCO_val2014_000000000002.jpg"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub.jpg").mkdir()
    assert port_images.list_jpgs(str(tmp_path)) == \
        jax_images.list_jpgs(str(tmp_path))


def _jax_cfg(bidirectional=True):
    return JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=0.0, bidirectional=bidirectional),
        image=ImageConfig(num_channels=(3, 4, 6), dropout=0.0),
        attention=AttentionConfig(hidden_dim=12, glimpses=2, dropout=0.0),
        classifier=ClassifierConfig(hidden_dim=10, dropout=0.0),
        max_answers=7, image_size=24, num_tokens=11)


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_state_dict_mapping_copy_matches_the_original(bidirectional):
    params = jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(1), _jax_cfg(bidirectional)))
    got = port_params.torch_state_from_params(params)
    expected = torch_export.torch_state_from_params(params)
    assert list(got) == list(expected)
    for name, value in expected.items():
        np.testing.assert_array_equal(got[name], value)
        assert got[name].dtype == value.dtype


def test_state_dict_mapping_refuses_what_the_original_refuses():
    params = {"text": {"embedding": np.zeros((3, 2))}, "image": {},
              "attention": {}, "classifier": {}}
    for fn in (port_params.torch_state_from_params,
               torch_export.torch_state_from_params):
        with pytest.raises(ValueError):
            fn(params)


@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bi", "uni"])
def test_inverse_bridge_gives_back_the_jax_tree(bidirectional):
    """JAX params -> VqaNet -> ``jax_params_from_model`` is the identity,
    and a nonzero ``bias_hh`` is folded into the fused bias."""
    cfg = _jax_cfg(bidirectional)
    params = jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(2), cfg))
    model = port_params.load_jax_params(
        VqaNet(ModelConfig.from_meta_dict(dataclasses.asdict(cfg)),
               device="cpu"), params)
    back = port_params.jax_params_from_model(model)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        model.text.lstm.bias_hh_l0 += 0.25
    shifted = port_params.jax_params_from_model(model)
    np.testing.assert_allclose(shifted["text"]["lstm_fwd"]["b"],
                               params["text"]["lstm_fwd"]["b"] + 0.25)


def _port_sources():
    files = glob.glob(os.path.join(REPO, "dl_vqa_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_no_port_source_imports_jax_or_the_jax_package():
    """``import dl_vqa_tpu`` / ``from dl_vqa_tpu`` followed by a dot or
    white space (``dl_vqa_tpu_torch`` is the port itself), ``jax``, and the
    ``experiments`` scripts that two of the port's kernels come from."""
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:dl_vqa_tpu|jax|experiments)(?:[.\s,]|$)",
        re.M)
    sources = _port_sources()
    assert len(sources) > 15
    names = {os.path.relpath(path, REPO) for path in sources}
    assert {"dl_vqa_tpu_torch/ops/vit_mlp_fused.py",
            "dl_vqa_tpu_torch/ops/layout_cases.py"} <= names
    offenders = []
    for path in sources:
        with open(path) as fd:
            offenders += [(os.path.relpath(path, REPO), m.group(0).strip())
                          for m in pattern.finditer(fd.read())]
    assert not offenders, offenders
    assert pattern.search("from dl_vqa_tpu.data import text\n")
    assert pattern.search("    import dl_vqa_tpu\n")
    assert pattern.search("import jax.numpy as jnp\n")
    assert pattern.search("from experiments import probe_vit_mlp_fused\n")
    assert not pattern.search("from dl_vqa_tpu_torch.ops import lstm\n")


# -- copies of the data plane, the config and the checkpoint import --------

# Override values as users write them, and YAML 1.1's corners: ints in
# every base, floats with and without a mantissa dot, booleans, nulls,
# quoted strings, flow lists, and text YAML refuses (kept as written).
OVERRIDE_VALUES = [
    "0", "-1", "+1", "42", "1_000", "0x1F", "017", "08", "0b101", "1:30",
    "0o17", "5e-4", "5.0e-4", "-5e-4", "1e3", "2e5", ".5", "1.", "3.0",
    "0.875", "+12.5e+3", "1.5e3", "1e-5.5", "-.inf", ".nan", "inf", "NaN",
    "on", "Off", "yes", "NO", "True", "false", "TRUE", "tRue", "y", "n",
    "null", "~", "Null", "none", "None", "", '""', "''", "'a b'", "'it''s'",
    '"x\\ty"', '"a\\"b"', '"2e5"', "[3, 8]", "[a, 1, 2.5, [1,2]]", "[]",
    "[ ]", "[1,]", "[5e-4, on, null, \"q\", 'r']", "a b", "./x.npz",
    "/a/b", "a,b", "a.b.c", "tpu.x", "-x", "x-", "=", "a=b", "*", "+", "|",
    "|-", ">", "%x", "@x", "`x", " 5e-4", "  7  ", "12:30:45", "bfloat16",
]


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_override_values_parse_as_the_yaml_parser_reads_them(raw):
    got, expected = port_config_core._parse_value(raw), \
        jax_config_core._parse_value(raw)
    assert type(got) is type(expected)
    if isinstance(expected, float) and np.isnan(expected):
        assert np.isnan(got)
    else:
        assert got == expected


@pytest.mark.parametrize("raw", ["-", "- a", "{a: 1}", "a: b", "x #c",
                                 "!!str", "&a", "#x", "?x", "2024-01-01"])
def test_yaml_the_port_does_not_read_raises(raw):
    """Mappings, comments, block sequences, tags, anchors and timestamps
    raise instead of being read another way than PyYAML reads them."""
    with pytest.raises(ValueError, match="override value"):
        port_config_core._parse_value(raw)


@pytest.mark.parametrize("overrides", [
    ["train.image.stride=2", "++tpu.remat=on", "+main.extra=1"],
    ["~tpu.profile_dir", "train.image.num_channels=[3, 8]"],
    ["~tpu.remat=false", "train.lr.lr_value=5e-4"],
])
def test_apply_overrides_and_flatten_copies(overrides):
    from dl_vqa_tpu_torch.config.presets import preset

    base = preset("config")
    got = port_config_core.apply_overrides(base, overrides)
    assert got == jax_config_core.apply_overrides(base, overrides)
    assert port_config_core.flatten(got["train"]) == \
        jax_config_core.flatten(got["train"])
    for bad in (["+train.batch_size=3"], ["+++x=1"], ["~nope"], ["nokey"],
                ["~tpu.remat=true"]):
        with pytest.raises(ValueError):
            jax_config_core.apply_overrides(base, bad)
        with pytest.raises(ValueError):
            port_config_core.apply_overrides(base, bad)


def test_schema_copy_matches_the_original():
    assert port_schema.CFG_SCHEMA == jax_schema.CFG_SCHEMA
    cfg = jax_config_core.compose("config")
    port_schema.validate(cfg)
    for mutate in (lambda c: c["train"].pop("lr"),
                   lambda c: c["tpu"].update(extra=1),
                   lambda c: c["train"].update(batch_size="64"),
                   lambda c: c["train"].update(num_epochs=True),
                   lambda c: c["tpu"].update(device_image_cache=3)):
        bad = jax_config_core.compose("config")
        mutate(bad)
        with pytest.raises(jax_schema.SchemaError) as jax_err:
            jax_schema.validate(bad)
        with pytest.raises(port_schema.SchemaError) as port_err:
            port_schema.validate(bad)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("learnable", [False, True, "hard"])
def test_split_generator_copy_matches_the_original(learnable):
    for n_q, n_img, seed in ((40, 7, 3), (9, 2, 0)):
        kw = dict(seed=seed, attr_seed=seed + 1, learnable=learnable,
                  data_subtype="val2014")
        assert port_synthetic.generate_vqa_split(n_q, n_img, **kw) == \
            jax_synthetic.generate_vqa_split(n_q, n_img, **kw)


ANSWERS = ["Two", "two dogs", "the cat.", "yes!", "1,000", "a-b", "don't",
           "isnt it", "3.5", "mr. T", "(red)", "10", "none", "an apple"]


def test_answer_normalization_and_vocab_copies_match():
    for a in ANSWERS:
        assert port_text.normalize_answer(a) == \
            jax_text.normalize_answer(a), a
    questions = {"questions": [{"question": q} for q in AWKWARD]}
    answers = {"annotations": [{"answers": [{"answer": a} for a in ANSWERS]},
                               {"answers": [{"answer": "two"}] * 10}]}
    assert list(port_text.prepare_questions(questions)) == \
        list(jax_text.prepare_questions(questions))
    assert list(port_text.prepare_answers(answers)) == \
        list(jax_text.prepare_answers(answers))
    for tables in ("CONTRACTIONS", "NUMBER_WORDS", "ARTICLES", "PUNCT_CHARS"):
        assert getattr(port_text, tables) == getattr(jax_text, tables)
    tokens = list(port_text.prepare_answers(answers))
    for kw in ({}, {"top_k": 3, "start": 1}, {"top_k": 50}):
        assert port_vocab.build_vocab(tokens, **kw) == \
            jax_vocab.build_vocab(tokens, **kw)
    vocab = port_vocab.build_vocab(tokens, start=1)
    for row in tokens:
        got = port_text.encode_answers(row, vocab)
        expected = jax_dataset.encode_answers(row, vocab)
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g, e)
    assert port_text.encode_answers(["nope"], vocab)[2] == 0


def test_normalize_uint8_chw_copy_matches():
    u8 = np.random.default_rng(0).integers(0, 256, (3, 5, 7, 3),
                                           dtype=np.uint8)
    got = port_images.normalize_uint8_chw(u8)
    expected = jax_images.normalize_uint8_chw(u8)
    assert got.dtype == expected.dtype
    np.testing.assert_array_equal(got, expected)


def _reference_state(bidirectional=True):
    """A state dict under the reference's names, from the JAX exporter."""
    params = jax.tree_util.tree_map(
        np.asarray, vqa.init(jax.random.PRNGKey(4), _jax_cfg(bidirectional)))
    state = {k: torch.from_numpy(np.array(v))
             for k, v in torch_export.torch_state_from_params(params).items()}
    state["text.lstm.bias_hh_l0"] += 0.5  # two biases that sum
    return state


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
def test_torch_import_copy_matches_the_original(tmp_path, bidirectional):
    state = _reference_state(bidirectional)
    got = port_torch_import.params_from_torch_state(state)
    expected = jax_torch_import.params_from_torch_state(state)
    flat, tree = jax.tree_util.tree_flatten(expected)
    flat_got, tree_got = jax.tree_util.tree_flatten(got)
    assert tree == tree_got
    for a, b in zip(flat_got, flat):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for blob in ({"epoch": 3, "model_state": state, "optimizer_state": {},
                  "note": "x"}, state):
        path = str(tmp_path / "model.pth")
        torch.save(blob, path)
        got_state, got_meta = port_torch_import.load_torch_blob(path)
        want_state, want_meta = jax_torch_import.load_torch_blob(path)
        assert got_meta == want_meta and list(got_state) == list(want_state)


@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 7), (False, 3)])
def test_epoch_order_copy_matches_the_original(shuffle, seed):
    from dl_vqa_tpu.data.pipeline import Batcher as JaxBatcher
    from dl_vqa_tpu_torch.data.pipeline import Batcher

    class Data:
        questions = np.zeros((37, 2), np.int32)

        def __len__(self):
            return 37

    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(
            Batcher(Data(), 8, shuffle=shuffle, seed=seed).epoch_order(epoch),
            JaxBatcher(Data(), 8, shuffle=shuffle, seed=seed).epoch_order(
                epoch))


@pytest.mark.parametrize("space_kind,history_len,n_startup", [
    ("grid", 0, 4), ("grid", 3, 4), ("grid", 9, 4), ("grid", 9, 10 ** 9),
    ("sampled", 0, 4), ("sampled", 6, 4), ("exhausted", 4, 4)])
def test_tpe_copy_matches_the_original(space_kind, history_len, n_startup):
    """``utils/tpe.py::suggest`` against its original on a seeded history:
    the same proposal and the same draws from the generator, in an
    enumerable space, one sampled (more than 4096 points), and one whose
    every point was tried (None)."""
    import random

    from dl_vqa_tpu.utils import tpe as jax_tpe
    from dl_vqa_tpu_torch.utils import tpe as port_tpe

    space = {"grid": {"a": [1, 2, 3], "b": ["x", "y", "z"], "c": [0.5, 2]},
             "sampled": {f"k{i}": list(range(6)) for i in range(6)},
             "exhausted": {"a": [1, 2], "b": [3, 4]}}[space_kind]
    rng = random.Random(history_len)
    keys = list(space)
    history = []
    for i in range(history_len):
        point = {k: space[k][(i * (j + 2)) % len(space[k])]
                 for j, k in enumerate(keys)}
        if space_kind == "exhausted":
            point = {"a": [1, 2][i % 2], "b": [3, 4][i // 2]}
        history.append((point, rng.random()))
    got = [], []
    for tpe, out in zip((jax_tpe, port_tpe), got):
        gen = random.Random(11)
        for _ in range(3):
            out.append(tpe.suggest(space, history, gen, n_startup=n_startup))
        out.append(gen.random())
    assert got[0] == got[1]
    if space_kind == "exhausted":
        assert got[1][0] is None
