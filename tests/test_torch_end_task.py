"""``dl_vqa_tpu_torch/tools/end_task.py`` at a tiny size on the CPU: the
hard corpus rendered, three epochs of ``main`` for a CNN and a ViT seed,
and
the best checkpoint scored by ``evaluate_vqa`` in each serving mode; one
JSON line a run."""

import json

import pytest

from dl_vqa_tpu_torch import config as port_config
from dl_vqa_tpu_torch.tools import end_task

NARROW = ("train.text.question_features=16 train.text.embedding_features=8 "
          "train.attention.hidden_dim=12 train.classifier.hidden_dim=10")


@pytest.mark.parametrize("model,flags,image", [
    ("cnn", ["--seeds", "0"], "train.image.num_channels=[3,4,8]"),
    ("vit", ["--seeds", "", "--vit-seeds", "1"],
     "train.image.num_channels=[3,32] train.image.num_heads=1 "
     "train.image.num_layers=1"),
], ids=["cnn", "vit"])
def test_end_task_trains_and_scores_every_serving_mode(tmp_path, capsys,
                                                       model, flags, image):
    results = end_task.main([
        "--root", str(tmp_path), "--device", "cpu", "--epochs", "3",
        "--n-train", "48", "--n-val", "24", "--n-images", "8",
        "--image-size", "32", "--max-answers", "20", "--batch-size", "16",
        "--train-overrides", f"{NARROW} {image}", *flags])
    (result,) = results
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"end_task"')]
    assert lines == results
    assert result["end_task"] == model and result["epochs"] == 3
    for key in ("best_val", "score_compute", "score_int8"):
        assert 0.0 <= result[key] <= 100.0
    # The loop's best checkpoint, scored as it was trained.
    assert result["score_compute"] == result["best_val"]
    assert result["delta_int8_pp"] == round(
        result["score_int8"] - result["score_compute"], 3)
    assert result["int8_scales"].startswith("(")
    if model == "cnn":
        assert 0.0 <= result["score_f8e4m3"] <= 100.0
        assert len(result["int8_scales"].split(",")) == 2
    else:
        assert result["score_f8e4m3"] is None
        assert len(result["int8_scales"].split(",")) == 4
    assert "hard" in result["corpus"] and result["device"] == "cpu"


def test_eval_overrides_describe_the_trained_model():
    """The evaluation's overrides turn ``config_eval`` into the trained
    preset's model: stride 1 and '+' for ``config``, the ViT's encoder and
    widths for ``config_vit``."""
    eval_train = port_config.compose("config_eval")["train"]
    for preset in ("config", "config_vit"):
        train = port_config.compose(preset)["train"]
        got = port_config.compose(
            "config_eval", end_task.eval_overrides(train, eval_train))
        assert got["train"] == train
