"""The port's entry points, ``dl_vqa_tpu_torch.main`` and
``dl_vqa_tpu_torch.evaluate_vqa``, on the CPU with ``device="cpu"``: a
training run on the JAX package's synthetic corpus (h5 stores) at tiny
widths in f32, its best checkpoint scored by the port's evaluation and by
the JAX package's ``evaluate_vqa.evaluate_hw2``, the settings the port
refuses, a missing store with no JPEG directory to build it from, and the
card the entry points ask for by default (the online JPEG pipeline, the
store builder, ``tpu.profile_dir`` and ``tpu.debug_nans``:
``tests/test_torch_online.py``; the entry points as several processes:
``tests/test_torch_multihost.py``)."""

import dataclasses
import glob
import os
import sys

import pytest
import torch

from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu_torch import config as port_config
from dl_vqa_tpu_torch import evaluate_vqa as port_eval
from dl_vqa_tpu_torch import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = 24


def _overrides(profile, tmp_path):
    return [
        "main.use_full=false",
        f"main.small.paths.base_path={profile['paths']['base_path']}",
        f"main.small.paths.vocab_path={tmp_path}/vocab.json",
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
        "train.num_epochs=2", "train.batch_size=16", "train.max_answers=12",
        f"train.image_size={IMAGE}", "train.text.question_features=16",
        "train.text.embedding_features=8",
        "train.image.num_channels=[3, 4, 6]", "train.attention.hidden_dim=12",
        "train.classifier.hidden_dim=16", "tpu.compute_dtype=float32",
    ]


@pytest.fixture(scope="module")
def profile(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return jax_synthetic.make_synthetic_corpus(
        root, n_train=40, n_val=24, n_images=6, image_size=IMAGE,
        max_answers=12, learnable=True)


def test_main_and_evaluate_give_the_jax_evaluation_score(profile, tmp_path):
    """The port trains 2 epochs (the vocab built on the way, the table on,
    a mid-epoch save), writes ``model.ckpt`` and ``last.ckpt``; the port's
    evaluation of ``model.ckpt`` (the model of ``config``: stride 1, '+')
    returns the loop's best score, and the JAX package's ``evaluate_hw2``
    on the same checkpoint returns the same rounded score (f32 logits that
    agree to 1e-5; no sample of this corpus sits that close to a tie)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import evaluate_vqa as jax_eval

    overrides = _overrides(profile, tmp_path)
    best = port_main.main(port_config.compose(
        "config", overrides + ["tpu.device_image_cache=on",
                               "tpu.checkpoint_every_steps=1"]),
        device="cpu")
    assert 0.0 <= best <= 100.0
    exp_dirs = glob.glob(str(tmp_path / "logs" / "final_model_*"))
    assert len(exp_dirs) == 1
    names = sorted(os.listdir(exp_dirs[0]))
    assert "model.ckpt" in names and "last.ckpt" in names
    assert os.path.exists(tmp_path / "vocab.json")
    eval_overrides = overrides + [
        f"main.small.paths.pretrained_model_path={exp_dirs[0]}/model.ckpt",
        "train.image.stride=1", "train.attention.do_option=+"]
    score = port_eval.evaluate_hw2(eval_overrides, device="cpu")
    assert score == round(best, 3)
    assert port_eval.evaluate_hw2(
        eval_overrides + ["tpu.device_image_cache=off"], device="cpu") == score
    assert jax_eval.evaluate_hw2(eval_overrides) == score


@pytest.fixture(scope="module")
def f8_trained(profile, tmp_path_factory):
    """One epoch of the port's ``main`` with the f8 store, which trains
    through its straight-through backward; the overrides and the best
    checkpoint."""
    tmp_path = tmp_path_factory.mktemp("f8_run")
    overrides = _overrides(profile, tmp_path)
    port_main.main(port_config.compose(
        "config", overrides + ["train.num_epochs=1",
                               "train.image.store_dtype=f8e4m3"]),
        device="cpu")
    (exp_dir,) = glob.glob(str(tmp_path / "logs" / "final_model_*"))
    return overrides + [
        f"main.small.paths.pretrained_model_path={exp_dir}/model.ckpt",
        "train.image.stride=1", "train.attention.do_option=+"]


@pytest.mark.parametrize("mode", ["compute", "f8e4m3", "int8"])
def test_evaluate_scores_the_serving_modes_as_the_jax_package(f8_trained,
                                                              mode):
    """A checkpoint trained in the f8 mode, scored in each serving mode by
    both packages' ``evaluate_hw2``: the same rounded score. int8 has no
    scales in the checkpoint, so both calibrate on the same rows of the
    train store (``linspace`` over its images) and score with them; the
    integer codes agree but where conv0's f32 sums, taken in another
    order, sit on a rounding boundary, and no answer of this corpus moves
    with such a code."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import evaluate_vqa as jax_eval

    overrides = f8_trained + [f"train.image.store_dtype={mode}"]
    score = port_eval.evaluate_hw2(overrides, device="cpu")
    assert 0.0 <= score <= 100.0
    assert jax_eval.evaluate_hw2(overrides) == score


@pytest.mark.parametrize("override,error,what", [
    ("tpu.checkpoint_backend=orbax", NotImplementedError, "Orbax"),
    ("tpu.mesh.model=2", ValueError,
     r"mesh 0x1x1x2x1 \(data x seq x expert x model x stage\) needs 2 "
     "devices, have 1"),
    ("tpu.mesh.data=4", ValueError,
     r"mesh 4x1x1x1x1 \(data x seq x expert x model x stage\) needs 4 "
     "devices, have 1"),
    ("tpu.zero_stage=1", None, "tpu.zero_stage=1 is a no-op"),
    ("tpu.mesh.stage=2 train.image.encoder=vit", ValueError,
     r"mesh 0x1x1x1x2 \(data x seq x expert x model x stage\) needs 2 "
     "devices, have 1"),
    ("tpu.mesh.expert=2", ValueError,
     r"mesh 0x1x2x1x1 \(data x seq x expert x model x stage\) needs 2 "
     "devices, have 1"),
    ("tpu.mesh.seq=2 train.image.encoder=vit train.image.moe_experts=4",
     ValueError,
     r"mesh 0x2x1x1x1 \(data x seq x expert x model x stage\) needs 2 "
     "devices, have 1"),
    ("tpu.pipeline_microbatches=4", None, '"pipeline_microbatches": 4'),
    ("tpu.image_builder_backend=pil "
     "main.small.train_paths.processed_imgs={tmp}/train_pil.h5", None,
     "(exact, "),
], ids=["tpu.checkpoint_backend=orbax-Orbax", "tpu.mesh.model=2-item 9",
        "tpu.mesh.data=4-item 9", "tpu.zero_stage=1-item 9",
        "tpu.mesh.stage=2-item 9", "tpu.mesh.expert=2-item 9",
        "tpu.mesh.seq=2-item 9", "tpu.pipeline_microbatches=4-item 9",
        "tpu.image_builder_backend=pil-queue 3"])
def test_settings_the_port_lacks_raise_with_their_roadmap_item(
        profile, tmp_path, override, error, what):
    """The settings still missing raise with their ROADMAP item (the Orbax
    backend). The builder's ``backend="pil"`` (queue 3 until the exact
    decoder) builds a missing store with the exact decoder. Every mesh
    axis is ported: in one process
    ``tpu.mesh.data=4``, ``tpu.mesh.model=2``, ``tpu.mesh.stage=2``,
    ``tpu.mesh.expert=2`` and ``tpu.mesh.seq=2`` (with a ViT-MoE too)
    raise the mesh's oversubscription error, as JAX's ``make_mesh`` does;
    a ZeRO stage runs with its no-op logged (one 'data' shard), and
    ``tpu.pipeline_microbatches`` at 'stage' 1 is ignored, as JAX ignores
    it: the run trains."""
    overrides = (_overrides(profile, tmp_path)
                 + override.format(tmp=tmp_path).split())
    if error is None:
        port_main.main(port_config.compose(
            "config", overrides + ["train.num_epochs=1"]), device="cpu")
        (log,) = glob.glob(str(tmp_path / "logs" / "final_model_*" / "*.log"))
        assert what in open(log).read()
        return
    with pytest.raises(error, match=what):
        port_main.main(port_config.compose("config", overrides),
                       device="cpu")


@pytest.mark.parametrize("case", ["f8e4m3", "int8", "fused_ops_vit",
                                  "expert_without_moe"])
def test_settings_that_still_raise_under_model_and_expert(
        profile, tmp_path, monkeypatch, case):
    """The quantized image modes with ``tpu.mesh.model=2`` are taken by
    both entry points: in one process they reach the mesh, whose
    oversubscription error is JAX's (the ranks run them:
    ``tests/test_torch_tensor_parallel.py``). ``fused_ops`` on a ViT over a
    mesh of 'model' 2 raises in the steps, naming ROADMAP queue 2 (kernel
    8 fuses the MLP that 'model' splits; the port's own option);
    ``tpu.mesh.expert=2`` without a ViT-MoE exits with the JAX package's
    words once the mesh is made (a mesh of 'expert' 2 stands in for the
    two ranks here)."""
    from dl_vqa_tpu_torch import parallel
    from dl_vqa_tpu_torch.main import check_supported
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.parallel.mesh import Mesh
    from dl_vqa_tpu_torch.train import make_train_step

    overrides = _overrides(profile, tmp_path)
    if case == "fused_ops_vit":
        cnn = ModelConfig()
        vit = dataclasses.replace(cnn, image=dataclasses.replace(
            cnn.image, encoder="vit", num_channels=(3, 256)))
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            make_train_step(vit, fused_ops=True,
                            mesh=Mesh({"data": 1, "model": 2}))
        return
    if case == "expert_without_moe":
        monkeypatch.setattr(parallel, "make_mesh", lambda *a, **k: Mesh(
            {"data": 1, "expert": 2, "model": 1}))
        with pytest.raises(SystemExit, match="expert-major"):
            port_main.main(port_config.compose(
                "config", overrides + ["tpu.mesh.expert=2"]), device="cpu")
        assert not os.path.exists(tmp_path / "vocab.json")
        return
    mode = [f"train.image.store_dtype={case}", "tpu.mesh.model=2"]
    check_supported(port_config.compose("config", overrides + mode))
    oversubscribed = (r"mesh 0x1x1x2x1 \(data x seq x expert x model x "
                      r"stage\) needs 2 devices, have 1")
    with pytest.raises(ValueError, match=oversubscribed):
        port_main.main(port_config.compose("config", overrides + mode),
                       device="cpu")
    with pytest.raises(ValueError, match=oversubscribed):
        port_eval.evaluate_hw2(overrides + mode, device="cpu")
    assert not os.path.exists(tmp_path / "vocab.json")


def test_sweeps_run_and_a_missing_store_is_refused(profile, tmp_path,
                                                   monkeypatch):
    """``-m`` runs a sweep: a trial a point of the comma-valued override
    (the preset named first, the other overrides on every trial), each
    trained by ``main`` on the card by default, and the best value
    returned. ``main`` is replaced by a stand-in here; a real sweep on the
    CPU is in ``tests/test_torch_sweep.py``."""
    trials = []

    def stand_in(cfg, device="cuda"):
        trials.append((cfg["train"]["image"]["stride"], cfg["main"]["seed"],
                       cfg["train"]["attention"]["variant"], device))
        return 10.0 * cfg["train"]["image"]["stride"]

    monkeypatch.setattr(port_main, "main", stand_in)
    best = port_main._cli(["-m", "config_san", "train.image.stride=1,2",
                           "main.seed=7"])
    assert best == 20.0
    assert trials == [(1, 7, "stacked", "cuda"), (2, 7, "stacked", "cuda")]
    monkeypatch.undo()
    overrides = _overrides(profile, tmp_path) + [
        f"main.small.val_paths.processed_imgs={tmp_path}/missing.h5",
        "main.small.val_paths.imgs=no_such_dir"]
    with pytest.raises(FileNotFoundError,
                       match="missing.h5.*no_such_dir.*preprocess_images"):
        port_main.main(port_config.compose("config", overrides), device="cpu")


def test_the_entry_points_ask_for_the_card_by_default(profile, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_config.compose("config", _overrides(profile, tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        port_main.main(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        port_eval.evaluate_hw2(_overrides(profile, tmp_path))
    assert not os.path.exists(tmp_path / "logs")  # nothing ran
