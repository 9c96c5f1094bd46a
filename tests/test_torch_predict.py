"""The port's Predictor and checkpoint reader, its import boundary, and
chip_smoke.py's refusal to run without a GPU. On the CPU."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

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
from dl_vqa_tpu.utils.checkpoint import save_checkpoint
from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet
from dl_vqa_tpu_torch.predict import Predictor
from dl_vqa_tpu_torch.utils.checkpoint import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["what", "color", "is", "the", "dog", "how", "many"]
ANSWERS = ["yes", "no", "2", "red", "blue"]


def _jax_cfg():
    return JaxModelConfig(
        text=TextConfig(question_features=16, embedding_features=8,
                        dropout=0.0),
        image=ImageConfig(num_channels=(3, 4, 6, 8), dropout=0.0),
        attention=AttentionConfig(hidden_dim=12, glimpses=2, dropout=0.0),
        classifier=ClassifierConfig(hidden_dim=10, dropout=0.0),
        max_answers=len(ANSWERS), image_size=40, num_tokens=len(WORDS) + 1,
    )


def _vocab():
    return {"question": {w: i + 1 for i, w in enumerate(WORDS)},
            "answer": {a: i + 1 for i, a in enumerate(ANSWERS)}}


def _write(tmp_path, full_state):
    cfg = _jax_cfg()
    params = vqa.init(jax.random.PRNGKey(4), cfg)
    tree = {"params": params, "step": jnp.zeros(())} if full_state else params
    path = str(tmp_path / "model.npz")
    save_checkpoint(path, tree, epoch=3, model_cfg=cfg,
                    extra_meta={"max_question_length": 6})
    vocab_path = str(tmp_path / "vocab.json")
    with open(vocab_path, "w") as fd:
        json.dump(_vocab(), fd)
    return cfg, params, path, vocab_path


@pytest.mark.parametrize("full_state", [False, True],
                         ids=["params", "train_state"])
def test_npz_checkpoint_gives_the_jax_logits(tmp_path, full_state):
    cfg, params, path, vocab_path = _write(tmp_path, full_state)
    predictor = Predictor.from_checkpoint(path, vocab_path, device="cpu",
                                          compute_dtype=torch.float32)
    assert predictor.max_question_length == 6
    assert dataclasses.asdict(predictor.model_cfg) == dataclasses.asdict(cfg)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    encoded, lengths = predictor.encode_questions(
        ["what color is the dog", "how many", "zebra"])
    expected = np.asarray(vqa.apply(params, cfg, jnp.asarray(images),
                                    jnp.asarray(encoded),
                                    jnp.asarray(lengths)))
    got = predictor.forward_logits(images, encoded, lengths)
    np.testing.assert_allclose(got, expected, atol=2e-5, rtol=1e-4)
    probs = predictor.forward_probs(images, encoded, lengths)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)


def test_load_params_rebuilds_the_tree(tmp_path):
    _, params, path, _ = _write(tmp_path, full_state=True)
    tree, meta = load_params(path, with_meta=True)
    assert meta["epoch"] == 3 and meta["max_question_length"] == 6
    assert set(tree) == set(params)
    np.testing.assert_array_equal(tree["text"]["embedding"],
                                  np.asarray(params["text"]["embedding"]))


def test_encoding_and_answer_ids_follow_the_jax_predictor():
    cfg = ModelConfig.from_meta_dict(dataclasses.asdict(_jax_cfg()))
    predictor = Predictor(cfg, VqaNet(cfg, device="cpu"), _vocab(),
                          device="cpu", max_question_length=4)
    encoded, lengths = predictor.encode_questions(
        ["what color is the dog", "", "how many?", "zebra"])
    # '?' appended and tokenized; truncated at 4; length at least 1.
    np.testing.assert_array_equal(encoded[0], [1, 2, 3, 4])
    np.testing.assert_array_equal(lengths, [4, 1, 2, 1])
    np.testing.assert_array_equal(encoded[2], [6, 7, 0, 0])
    np.testing.assert_array_equal(encoded[3], [0, 0, 0, 0])
    top = predictor.top_k_from_probs(np.array([0.1, 0.5, 0.0, 0.3, 0.1]), 2)
    assert top == [("no", 0.5), ("red", 0.3)]  # column i is answer id i + 1
    answers = predictor.predict(np.zeros((2, 40, 40, 3), np.uint8),
                                ["what color", "how many"], top_k=3)
    assert [len(a) for a in answers] == [3, 3]
    with pytest.raises(ValueError):
        predictor.predict(np.zeros((1, 40, 40, 3), np.uint8), ["a", "b"])


def test_checkpoint_without_model_cfg_needs_one(tmp_path):
    params = vqa.init(jax.random.PRNGKey(0), _jax_cfg())
    path = str(tmp_path / "bare.npz")
    save_checkpoint(path, params)
    vocab_path = str(tmp_path / "vocab.json")
    with open(vocab_path, "w") as fd:
        json.dump(_vocab(), fd)
    with pytest.raises(ValueError, match="model_cfg"):
        Predictor.from_checkpoint(path, vocab_path, device="cpu")
    cfg = ModelConfig.from_meta_dict(dataclasses.asdict(_jax_cfg()))
    with pytest.warns(UserWarning, match="max_question_length"):
        predictor = Predictor.from_checkpoint(path, vocab_path, device="cpu",
                                              model_cfg=cfg)
    assert predictor.max_question_length == 23


def test_predictor_defaults_to_the_gpu(tmp_path):
    """No device passed: the GPU, and without one an error that names it,
    from the constructor and from ``from_checkpoint`` alike."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ModelConfig.from_meta_dict(dataclasses.asdict(_jax_cfg()))
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(cfg, VqaNet(cfg, device="cpu"), _vocab())
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor.from_checkpoint(str(tmp_path / "none.npz"),
                                  str(tmp_path / "none.json"))


def test_port_imports_no_jax_yaml_pil_or_h5py():
    """After importing every port module, answering one request (also
    with ``fused_ops=True``) and taking one CPU train step with the CNN
    model and with the ViT model in a fresh interpreter, none of JAX, the
    JAX package (``dl_vqa_tpu`` or any ``dl_vqa_tpu.*``), the
    ``experiments`` scripts, PyYAML, PIL or h5py is loaded."""
    code = (
        "import importlib, pkgutil, sys, numpy as np, torch\n"
        "import dl_vqa_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dl_vqa_tpu_torch.__path__, 'dl_vqa_tpu_torch.')]\n"
        "assert len(names) > 15, names\n"
        "assert {'dl_vqa_tpu_torch.ops.vit_mlp_fused',"
        " 'dl_vqa_tpu_torch.ops.layout_cases'} <= set(names), names\n"
        "for name in names: importlib.import_module(name)\n"
        "from dl_vqa_tpu_torch.models.configs import ModelConfig\n"
        "from dl_vqa_tpu_torch.models.vqa import VqaNet\n"
        "from dl_vqa_tpu_torch.predict import Predictor\n"
        "from dl_vqa_tpu_torch.train import create_train_state, make_train_step\n"
        "images = ({'num_channels': [3, 16, 4]}, {'encoder': 'vit',"
        " 'num_channels': [3, 64], 'patch_size': 10, 'num_layers': 1,"
        " 'num_heads': 1})\n"
        "for image in images:\n"
        "  cfg = ModelConfig.from_meta_dict({'text': {'question_features': 8,"
        " 'embedding_features': 4}, 'image': image,"
        " 'attention': {'hidden_dim': 6}, 'classifier': {'hidden_dim': 5},"
        " 'max_answers': 3, 'image_size': 20, 'num_tokens': 3})\n"
        "  model = VqaNet(cfg, device='cpu')\n"
        "  p = Predictor(cfg, model, {'question': {'a': 1, 'b': 2},"
        " 'answer': {'x': 1, 'y': 2, 'z': 3}}, device='cpu')\n"
        "  print(p.predict(np.zeros((1, 20, 20, 3), np.uint8), ['a b'], 2))\n"
        "  p.fused_ops = True\n"
        "  print(p.predict(np.zeros((1, 20, 20, 3), np.uint8), ['a b'], 2))\n"
        "  state = create_train_state(model, 1e-3, device='cpu')\n"
        "  step = make_train_step(cfg, compute_dtype=torch.float32)\n"
        "  batch = {'images': np.zeros((2, 20, 20, 3), np.uint8),"
        " 'questions': np.array([[1, 2], [2, 0]], np.int32),"
        " 'lengths': np.array([2, 1], np.int32),"
        " 'answer_indices': np.array([[1, 0], [3, 2]], np.int32),"
        " 'answer_values': np.array([[10, 0], [6, 4]], np.int32)}\n"
        "  state, metrics = step(state, batch,"
        " torch.Generator().manual_seed(0))\n"
        "  assert state.step == 1 and bool(torch.isfinite(metrics['loss']))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'yaml', 'PIL', 'h5py',"
        " 'dl_vqa_tpu', 'experiments')"
        " or m.startswith(('jax.', 'dl_vqa_tpu.', 'experiments.'))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_exits_nonzero_without_cuda(tmp_path, alone):
    """No CUDA here: the script fails and prints no result, in the
    checkout and in a directory that holds only the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
