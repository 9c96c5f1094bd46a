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

from dl_vqa_tpu.data import dataset as jax_dataset
from dl_vqa_tpu.data import images as jax_images
from dl_vqa_tpu.data import text as jax_text
from dl_vqa_tpu.models import vqa
from dl_vqa_tpu.models.configs import (
    AttentionConfig,
    ClassifierConfig,
    ImageConfig,
    ModelConfig as JaxModelConfig,
    TextConfig,
)
from dl_vqa_tpu.utils import torch_export
from dl_vqa_tpu_torch.data import images as port_images
from dl_vqa_tpu_torch.data import text as port_text
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.utils import params as port_params

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
