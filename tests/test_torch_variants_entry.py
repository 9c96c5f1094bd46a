"""The entry points of the attention and text variants and of the
ViT-MoE on the CPU, against the JAX package's: ``main`` of ``config_san``,
``config_transformer_co`` and ``config_vit_moe`` for one short epoch with
``evaluate_vqa`` on its best checkpoint, and the serving fronts (the HTTP
front, ``predict --submission``) on a JAX checkpoint of each, at tiny
widths cut by dotlist. The modules' parity is
``tests/test_torch_variants.py``'s and ``tests/test_torch_moe.py``'s.
"""

import glob
import os
import sys

import numpy as np
import pytest

from dl_vqa_tpu.data import synthetic as jax_synthetic
from dl_vqa_tpu_torch import config as port_config
from dl_vqa_tpu_torch import evaluate_vqa as port_eval
from dl_vqa_tpu_torch import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# config_vit_moe cut to the tests' size: one MoE block of four experts, a
# head of 64, patch 8. Its main run takes LR 5e-3: at 5e-4 the two steps of
# the short epoch leave its val score at 0, and no best checkpoint is
# written for evaluate_vqa to score.
MOE_IMAGE = ["train.image.encoder=vit", "train.image.num_channels=[3, 64]",
             "train.image.patch_size=8", "train.image.num_layers=1",
             "train.image.num_heads=1", "train.image.moe_experts=4"]


# ------------------------------------------------------------ fronts

@pytest.mark.parametrize("preset", ["config_san", "config_transformer_co",
                                    "config_vit_moe"])
def test_the_fronts_serve_a_jax_checkpoint_of_each_variant(tmp_path, preset):
    """A JAX checkpoint of the preset's variant (tiny widths): the port's
    HTTP front answers a posted JPEG with the Predictor's top-3 for it, and
    ``predict --submission`` writes the file the JAX package's
    ``predict.py --submission`` writes on the same checkpoint."""
    import base64
    import json
    import threading

    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch import predict as port_predict
    from dl_vqa_tpu_torch import serve
    from dl_vqa_tpu_torch.predict import Predictor
    from tests.test_torch_serve import _corpus, _post

    train = config_mod.compose(preset)["train"]
    overrides, jpegs, _ = _corpus(tmp_path, extra=[
        f"train.text.encoder={train['text']['encoder']}",
        f"train.attention.variant={train['attention']['variant']}",
        "train.text.num_heads=4",
        *(MOE_IMAGE if train["image"]["moe_experts"] else [])])
    cfg = config_mod.compose("config_eval", overrides=overrides)
    question = "what color is the cat?"
    (want,) = Predictor.from_config(cfg, device="cpu").predict(
        [jpegs[0]], [question], top_k=3)
    httpd, service = serve.build_server(cfg, port=0, max_batch=4,
                                        batch_window_ms=5.0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with open(jpegs[0], "rb") as fd:
            image_b64 = base64.b64encode(fd.read()).decode()
        status, payload = _post(
            f"http://127.0.0.1:{httpd.server_address[1]}", "/v1/answer",
            {"image_b64": image_b64, "question": question, "top_k": 3})
    finally:
        service.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert status == 200
    assert [a for a, _ in payload["answers"]] == [a for a, _ in want]
    np.testing.assert_allclose([p for _, p in payload["answers"]],
                               [p for _, p in want], rtol=1e-6)

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import predict as jax_predict

    files = {}
    for name, run in (("port", port_predict.main),
                      ("jax", jax_predict.main)):
        files[name] = str(tmp_path / f"{name}.json")
        args = ["--submission", files[name], *overrides,
                "train.batch_size=8",
                f"main.small.val_paths.vqaDataset={tmp_path}/{name}_val.npz"]
        assert run(args + (["--device", "cpu"] if name == "port" else [])) \
            == 0
    with open(files["port"]) as fd, open(files["jax"]) as fj:
        assert json.load(fd) == json.load(fj)


# ------------------------------------------------------------ main

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return jax_synthetic.make_synthetic_corpus(
        root, n_train=32, n_val=16, n_images=4, image_size=24,
        max_answers=12, learnable=True)


def _overrides(profile, tmp_path, preset):
    text = (["train.text.question_features=8"] if preset == "config_san"
            else ["train.text.question_features=16",
                  "train.text.num_heads=4"])
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
        "train.num_epochs=1", "train.batch_size=16", "train.max_answers=12",
        "train.image_size=24", "train.text.embedding_features=8",
        "train.image.num_channels=[3, 4, 6]", "train.attention.hidden_dim=12",
        "train.classifier.hidden_dim=16", "tpu.compute_dtype=float32",
        *text, *(MOE_IMAGE + ["train.lr.lr_value=5.0e-3"]
                 if preset == "config_vit_moe" else [])]


@pytest.mark.parametrize("preset", ["config_san", "config_transformer_co",
                                    "config_vit_moe"])
def test_main_trains_the_preset_and_evaluate_gives_its_score(corpus,
                                                             tmp_path,
                                                             preset):
    """One epoch of the preset through ``main`` (its variant, widths cut
    by dotlist), a mid-epoch save; ``evaluate_vqa`` of the best checkpoint
    with the preset's model settings gives the loop's best score, and for
    transformer_co and the ViT-MoE so does the JAX package's
    ``evaluate_hw2`` on the port's checkpoint."""
    overrides = _overrides(corpus, tmp_path, preset)
    cfg = port_config.compose(preset, overrides
                              + ["tpu.checkpoint_every_steps=1"])
    moe = preset == "config_vit_moe"
    assert cfg["train"]["attention"]["variant"] in (
        ("single",) if moe else ("stacked", "co"))
    best = port_main.main(cfg, device="cpu")
    (exp_dir,) = glob.glob(str(tmp_path / "logs" / "*_model_*"))
    assert {"model.ckpt", "last.ckpt"} <= set(os.listdir(exp_dir))
    train = cfg["train"]
    variant = [f"train.attention.variant={train['attention']['variant']}",
               f"train.text.encoder={train['text']['encoder']}",
               f"train.max_answers={train['max_answers']}",
               "train.image.stride=1", "train.attention.do_option=+",
               *(MOE_IMAGE if moe else [])]
    eval_overrides = overrides + variant + [
        f"main.small.paths.pretrained_model_path={exp_dir}/model.ckpt"]
    score = port_eval.evaluate_hw2(eval_overrides, device="cpu")
    assert score == round(best, 3)
    if preset in ("config_transformer_co", "config_vit_moe"):
        if REPO not in sys.path:
            sys.path.insert(0, REPO)
        import evaluate_vqa as jax_eval

        assert jax_eval.evaluate_hw2(eval_overrides) == score
