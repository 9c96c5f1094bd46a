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


def test_port_imports_no_jax_yaml_pil_or_h5py(tmp_path):
    """After importing every port module, answering one request (also
    with ``fused_ops=True``) and taking one CPU train step with the CNN
    model and with the ViT model, then making an ``.npy`` corpus and
    running the port's ``main`` on it (2 epochs, the image table, a
    mid-epoch save) and ``evaluate_vqa`` on its checkpoint, all on the CPU
    in a fresh interpreter, none of JAX, the JAX package (``dl_vqa_tpu`` or
    any ``dl_vqa_tpu.*``), the ``experiments`` scripts, PyYAML, PIL or
    h5py is loaded."""
    code = (
        "import glob, importlib, pkgutil, sys, numpy as np, torch\n"
        "import dl_vqa_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "dl_vqa_tpu_torch.__path__, 'dl_vqa_tpu_torch.')]\n"
        "assert len(names) > 30, names\n"
        "assert {'dl_vqa_tpu_torch.ops.vit_mlp_fused',"
        " 'dl_vqa_tpu_torch.ops.layout_cases', 'dl_vqa_tpu_torch.main',"
        " 'dl_vqa_tpu_torch.evaluate_vqa', 'dl_vqa_tpu_torch.train.loop',"
        " 'dl_vqa_tpu_torch.data.dataset', 'dl_vqa_tpu_torch.data.pipeline',"
        " 'dl_vqa_tpu_torch.data.device_cache',"
        " 'dl_vqa_tpu_torch.data.synthetic', 'dl_vqa_tpu_torch.config.core',"
        " 'dl_vqa_tpu_torch.utils.logger',"
        " 'dl_vqa_tpu_torch.utils.torch_import', 'dl_vqa_tpu_torch.serve',"
        " 'dl_vqa_tpu_torch.utils.native_front', 'dl_vqa_tpu_torch.ops._host',"
        " 'dl_vqa_tpu_torch.tools.make_serving_fixtures',"
        " 'dl_vqa_tpu_torch.parallel.mesh', 'dl_vqa_tpu_torch.parallel.multihost',"
        " 'dl_vqa_tpu_torch.parallel.zero'} <= set(names),"
        " names\n"
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
        "from dl_vqa_tpu_torch import config\n"
        "from dl_vqa_tpu_torch.data.synthetic import make_synthetic_corpus\n"
        "from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2\n"
        "from dl_vqa_tpu_torch.main import main\n"
        "root = sys.argv[1]\n"
        "prof = make_synthetic_corpus(root, n_train=24, n_val=8, n_images=4,"
        " image_size=20, max_answers=6, learnable=True)\n"
        "ov = ['main.use_full=false']\n"
        "for group, paths in prof.items():\n"
        "  ov += [f'main.small.{group}.{k}={v}' for k, v in paths.items()]\n"
        "ov += ['train.num_epochs=2', 'train.batch_size=8',"
        " 'train.max_answers=6', 'train.image_size=20',"
        " 'train.text.question_features=8', 'train.text.embedding_features=4',"
        " 'train.image.num_channels=[3, 4]', 'train.attention.hidden_dim=6',"
        " 'train.classifier.hidden_dim=5', 'tpu.compute_dtype=float32',"
        " 'tpu.device_image_cache=on', 'tpu.checkpoint_every_steps=2']\n"
        "best = main(config.compose('config', ov), device='cpu')\n"
        "ckpt, = glob.glob(root + '/logs/final_model_*/model.ckpt')\n"
        "score = evaluate_hw2(ov + [f'main.small.paths.pretrained_model_path="
        "{ckpt}', 'train.image.stride=1', 'train.attention.do_option=+'],"
        " device='cpu')\n"
        "assert score == round(best, 3), (score, best)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'yaml', 'PIL', 'h5py',"
        " 'dl_vqa_tpu', 'experiments')"
        " or m.startswith(('jax.', 'dl_vqa_tpu.', 'experiments.'))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
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


# -- the int8 serving mode's calibrate-once checkpoints, both ways --------

def _int8(cfg):
    return dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, store_dtype="int8", quant_scales=()))


def _jax_predictor(checkpoint, vocab_path):
    """The JAX package's Predictor over ``_jax_cfg()``'s model in the int8
    mode, composed as its entry points compose it."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import predict as jax_predict
    from dl_vqa_tpu import config as jax_config

    cfg = jax_config.compose("config", [
        "train.text.question_features=16", "train.text.embedding_features=8",
        "train.image.num_channels=[3, 4, 6, 8]", "train.image.stride=1",
        "train.image.store_dtype=int8", "train.attention.hidden_dim=12",
        "train.attention.do_option=+", "train.classifier.hidden_dim=10",
        f"train.max_answers={len(ANSWERS)}", "train.image_size=40",
        "tpu.compute_dtype=float32"])
    return jax_predict.Predictor(cfg, checkpoint, vocab_path)


def _images(seed=8, n=6):
    return np.random.default_rng(seed).integers(0, 256, (n, 40, 40, 3),
                                                dtype=np.uint8)


def test_calibrate_int8_saves_a_checkpoint_both_packages_serve(tmp_path):
    """The port calibrates the int8 stem on sample images and saves the
    parameters with the scales in the metadata (epoch and
    max_question_length carried through). The port reloads it with the
    scales, from the metadata alone or adopting them under a configuration
    that has none, and serves the same logits to the bit; the JAX package's
    Predictor adopts the same scales and its logits agree to 2e-4 (one
    code may move where conv0's sums meet a rounding boundary)."""
    cfg, _, path, vocab_path = _write(tmp_path, full_state=True)
    port_cfg = _int8(ModelConfig.from_meta_dict(dataclasses.asdict(cfg)))
    predictor = Predictor.from_checkpoint(path, vocab_path, device="cpu",
                                          model_cfg=port_cfg,
                                          compute_dtype=torch.float32)
    assert predictor.needs_int8_calibration
    saved = str(tmp_path / "calibrated.npz")
    predictor.calibrate_int8(_images(), save_to=saved)
    assert not predictor.needs_int8_calibration
    scales = predictor.model_cfg.image.quant_scales
    assert len(scales) == 3 and all(s > 0 for s in scales)
    images = _images(9, 3)
    encoded, lengths = predictor.encode_questions(
        ["what color is the dog", "how many", "is it"])
    logits = predictor.forward_logits(images, encoded, lengths)

    _, meta = load_params(saved, with_meta=True)
    assert meta["epoch"] == 3 and meta["max_question_length"] == 6
    assert tuple(meta["model_cfg"]["image"]["quant_scales"]) == scales
    for given in (None, port_cfg):
        again = Predictor.from_checkpoint(saved, vocab_path, device="cpu",
                                          model_cfg=given,
                                          compute_dtype=torch.float32)
        assert again.model_cfg.image.quant_scales == scales
        np.testing.assert_array_equal(
            again.forward_logits(images, encoded, lengths), logits)

    jax_side = _jax_predictor(saved, vocab_path)
    assert not jax_side.needs_int8_calibration
    assert jax_side.model_cfg.image.quant_scales == scales
    expected = np.asarray(jax_side._forward(
        jax_side.params, jnp.asarray(images), jnp.asarray(encoded),
        jnp.asarray(lengths)))
    np.testing.assert_allclose(logits, expected, atol=2e-4, rtol=0)


def test_a_jax_calibrate_once_checkpoint_serves_in_the_port(tmp_path):
    """The reverse: the JAX package's ``Predictor.calibrate_int8(save_to=
    ...)`` writes the scales; the port's Predictor adopts them (1e-6
    relative of the port's own calibration on the same images) and serves
    logits within 2e-4 of the JAX package's."""
    cfg, _, path, vocab_path = _write(tmp_path, full_state=False)
    jax_side = _jax_predictor(path, vocab_path)
    assert jax_side.needs_int8_calibration
    saved = str(tmp_path / "jax_calibrated.npz")
    jax_side.calibrate_int8(_images().astype(np.float32) / 255.0,
                            save_to=saved)
    scales = jax_side.model_cfg.image.quant_scales
    port_cfg = _int8(ModelConfig.from_meta_dict(dataclasses.asdict(cfg)))
    predictor = Predictor.from_checkpoint(saved, vocab_path, device="cpu",
                                          model_cfg=port_cfg,
                                          compute_dtype=torch.float32)
    assert predictor.model_cfg.image.quant_scales == scales
    mine = Predictor.from_checkpoint(path, vocab_path, device="cpu",
                                     model_cfg=port_cfg,
                                     compute_dtype=torch.float32)
    mine.calibrate_int8(_images().astype(np.float32) / 255.0)
    np.testing.assert_allclose(mine.model_cfg.image.quant_scales, scales,
                               rtol=1e-6)
    images = _images(9, 3)
    encoded, lengths = predictor.encode_questions(["what color", "dog", "is"])
    expected = np.asarray(jax_side._forward(
        jax_side.params, jnp.asarray(images), jnp.asarray(encoded),
        jnp.asarray(lengths)))
    np.testing.assert_allclose(
        predictor.forward_logits(images, encoded, lengths), expected,
        atol=2e-4, rtol=0)


# -- the command line and the submission, against the JAX package ---------

def _jax_main_module():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import predict as jax_predict

    return jax_predict


def test_cli_answers_an_image_and_exports_an_artifact(tmp_path, capsys):
    """``--image`` / ``--question``: the CLI prints the Predictor's top-k
    for the JPEG, and its answers rank as the JAX Predictor ranks the same
    decoded pixels. ``--export-artifact``: the CLI writes an AOT serving
    artifact of the same Predictor, whose logits for those pixels are the
    Predictor's to the bit."""
    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch import predict as port_predict
    from tests.test_torch_serve import _corpus

    overrides, jpegs, _ = _corpus(tmp_path)
    question = "what color is the cat?"
    assert port_predict.main(["--image", jpegs[1], "--question", question,
                              "--top-k", "3", "--device", "cpu",
                              *overrides]) == 0
    printed = capsys.readouterr().out.splitlines()
    predictor = Predictor.from_config(
        config_mod.compose("config_eval", overrides=overrides), device="cpu")
    (top,) = predictor.predict([jpegs[1]], [question], top_k=3)
    assert printed == [f"{jpegs[1]} | {question}"] + [
        f"  {p:6.3f}  {a}" for a, p in top]

    jax_predict = _jax_main_module()
    from dl_vqa_tpu import config as jax_config

    jax_cfg = jax_config.compose("config_eval", overrides=overrides)
    profile = jax_cfg["main"]["small"]
    jax_side = jax_predict.Predictor(
        jax_cfg, checkpoint_path=profile["paths"]["pretrained_model_path"],
        vocab_path=profile["paths"]["vocab_path"])
    with open(jpegs[1], "rb") as fd:
        pixels = predictor.preprocess_image(fd.read())
    encoded, lengths = jax_side.encode_questions([question])
    want = jax_side.top_k_from_probs(
        jax_side.forward_probs(pixels[None], encoded, lengths)[0], 3)
    assert [a for a, _ in top] == [a for a, _ in want]
    np.testing.assert_allclose([p for _, p in top], [p for _, p in want],
                               atol=2e-5, rtol=1e-4)
    from dl_vqa_tpu_torch.models.layers import normalize_images
    from dl_vqa_tpu_torch.utils.aot_export import load_artifact

    assert port_predict.main(["--export-artifact", str(tmp_path / "a"),
                              "--export-batch-sizes", "1,2", "--device",
                              "cpu", *overrides]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == (f"wrote serving artifact (batches (1, 2)) to "
                          f"{tmp_path / 'a'}")
    assert set(json.loads(printed[1])["export_seconds"]) == {"1", "2"}
    artifact = load_artifact(str(tmp_path / "a"), device="cpu")
    assert artifact.meta["compute_dtype"] == str(
        predictor.compute_dtype).split(".")[-1]
    images = normalize_images(torch.from_numpy(pixels[None]),
                              torch.float32).numpy()
    encoded, lengths = predictor.encode_questions([question])
    np.testing.assert_array_equal(
        artifact.logits(images, encoded, lengths),
        predictor.forward_logits(images, encoded, lengths))


@pytest.mark.parametrize("table", ["on", "off"])
def test_submission_equals_the_jax_packages(tmp_path, table):
    """``--submission`` over the val split of the JAX corpus (an h5 store),
    with the device image table on and off: the same file as the JAX
    package's ``predict.py --submission`` on the same checkpoint, one entry
    a val question in dataset order."""
    from dl_vqa_tpu_torch import predict as port_predict
    from tests.test_torch_serve import _corpus

    overrides, _, _ = _corpus(tmp_path)
    overrides += ["train.batch_size=8", f"tpu.device_image_cache={table}"]
    files = {}
    for name, run in (("port", port_predict.main),
                      ("jax", _jax_main_module().main)):
        files[name] = str(tmp_path / f"{name}.json")
        args = ["--submission", files[name], *overrides,
                f"main.small.val_paths.vqaDataset={tmp_path}/{name}_val.npz"]
        assert run(args + (["--device", "cpu"] if name == "port" else [])) \
            == 0
    with open(files["port"]) as fd:
        port_entries = json.load(fd)
    with open(files["jax"]) as fd:
        jax_entries = json.load(fd)
    assert port_entries == jax_entries
    with open(os.path.join(str(tmp_path), "data", "val_questions.json")) as fd:
        question_ids = [q["question_id"] for q in json.load(fd)["questions"]]
    assert [e["question_id"] for e in port_entries] == question_ids


def test_a_served_request_imports_no_jax_or_pil(tmp_path):
    """A fresh interpreter builds the port's HTTP front on a checkpoint the
    port saved, answers one request with a committed fixture JPEG, and has
    loaded none of JAX, the JAX package, PIL, PyYAML or h5py."""
    code = (
        "import base64, json, sys, threading, urllib.request\n"
        "from dl_vqa_tpu_torch import config, serve\n"
        "from dl_vqa_tpu_torch.models.configs import ModelConfig\n"
        "from dl_vqa_tpu_torch.models.vqa import VqaNet\n"
        "from dl_vqa_tpu_torch.tools.make_serving_fixtures import FIXTURES\n"
        "from dl_vqa_tpu_torch.utils.checkpoint import save_params\n"
        "root = sys.argv[1]\n"
        "with open(root + '/vocab.json', 'w') as fd:\n"
        "  json.dump({'question': {'a': 1, 'b': 2},"
        " 'answer': {'x': 1, 'y': 2, 'z': 3}}, fd)\n"
        "ov = ['main.use_full=false', 'train.max_answers=3',"
        " 'train.image_size=32', 'train.text.question_features=8',"
        " 'train.text.embedding_features=4',"
        " 'train.image.num_channels=[3, 4]', 'train.attention.hidden_dim=6',"
        " 'train.classifier.hidden_dim=5', 'tpu.compute_dtype=float32',"
        " f'main.small.paths.vocab_path={root}/vocab.json',"
        " f'main.small.paths.pretrained_model_path={root}/model.npz']\n"
        "cfg = config.compose('config_eval', ov)\n"
        "mc = ModelConfig.from_cfg(cfg['train'], 3)\n"
        "save_params(root + '/model.npz', VqaNet(mc, device='cpu'),"
        " model_cfg=mc, extra_meta={'max_question_length': 4})\n"
        "httpd, service = serve.build_server(cfg, port=0, device='cpu')\n"
        "thread = threading.Thread(target=httpd.serve_forever, daemon=True)\n"
        "thread.start()\n"
        "with open(FIXTURES + '/coco_640x480_420.jpg', 'rb') as fd:\n"
        "  raw = fd.read()\n"
        "req = urllib.request.Request("
        "f'http://127.0.0.1:{httpd.server_address[1]}/v1/answer',"
        " data=json.dumps({'image_b64': base64.b64encode(raw).decode(),"
        " 'question': 'a b', 'top_k': 2}).encode(), method='POST')\n"
        "with urllib.request.urlopen(req, timeout=30) as resp:\n"
        "  answers = json.loads(resp.read())['answers']\n"
        "service.stop(); httpd.shutdown(); httpd.server_close()\n"
        "assert [len(a) for a in answers] == [2, 2], answers\n"
        "bad = [m for m in sys.modules if m in ('jax', 'yaml', 'PIL', 'h5py',"
        " 'dl_vqa_tpu') or m.startswith(('jax.', 'dl_vqa_tpu.', 'PIL.'))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
