"""The six config presets of ``dl_vqa_tpu/config/*.yaml`` as Python dicts.

The card does not assure PyYAML, so the port carries the presets as code;
``tests/test_torch_config.py`` holds each to ``dl_vqa_tpu.config.compose``
of its YAML file. ``config`` is the training config of the reference-parity
model; the others differ from it in the keys each builder lists.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

__all__ = ["PRESETS", "preset"]


def _profile(size: str, logs: str) -> Dict[str, Any]:
    """The ``main.full`` or ``main.small`` group: where the corpus, the
    caches, the vocab and the logs live."""
    tag = "" if size == "full" else "_small"
    splits = {}
    for split, subtype in (("train", "train2014"), ("val", "val2014")):
        splits[f"{split}_paths"] = {
            "vqaDataset": f"./vqaDataset_{split}{tag}.npz",
            "questions": f"v2_OpenEnded_mscoco_{subtype}_questions.json",
            "answers": f"v2_mscoco_{subtype}_annotations.json",
            "imgs": subtype,
            "processed_imgs": f"./processed_{split}_images{tag}.h5",
        }
    return {
        "paths": {
            "pretrained_model_path": f"./model{tag}.ckpt",
            "base_path": "/datashare" if size == "full" else "./small_data",
            "logs": logs,
            "vocab_path": f"./vocab{tag}.json",
        },
        **splits,
    }


def _config() -> Dict[str, Any]:
    """``config.yaml``."""
    return {
        "main": {
            "experiment_name_prefix": "final_model",
            "seed": 1,
            "num_workers": 5,
            "use_full": True,
            "start_from_pretrained_model": False,
            "full": _profile("full", "logs_full/"),
            "small": _profile("small", "logs_small/"),
        },
        "train": {
            "text": {
                "encoder": "lstm",
                "question_features": 1024,
                "embedding_features": 300,
                "dropout": 0.3,
                "num_lstm_layers": 1,
                "bidirectional": True,
                "num_heads": 8,
                "num_layers": 2,
                "max_positions": 64,
            },
            "image": {
                "encoder": "cnn",
                "kernel_size": 3,
                "dropout": 0.3,
                "num_channels": [3, 64, 128, 256],
                "stride": 1,
                "do_skip_connection": False,
                "patch_size": 16,
                "num_layers": 4,
                "num_heads": 4,
                "store_dtype": "compute",
                "moe_experts": 0,
                "moe_top_k": 2,
                "moe_capacity_factor": 1.25,
                "moe_aux_weight": 0.01,
            },
            "attention": {
                "variant": "single",
                "hidden_dim": 1024,
                "glimpses": 2,
                "do_option": "+",
                "dropout": 0.3,
            },
            "classifier": {"hidden_dim": 1024, "dropout": 0.3},
            "max_answers": 3000,
            "image_size": 224,
            "central_fraction": 0.875,
            "n_epochs_stop": 24,
            "num_epochs": 80,
            "batch_size": 64,
            "save_model": True,
            "lr": {
                "lr_value": 5.0e-4,
                "lr_decay": 15,
                "lr_gamma": 0.1,
                "lr_step_size": 3,
            },
        },
        "tpu": {
            "online_images": False,
            "native_loader": False,
            "image_builder_backend": "auto",
            "checkpoint_backend": "npz",
            "checkpoint_every_steps": 0,
            "compute_dtype": "bfloat16",
            "mesh": {"data": -1, "model": 1, "stage": 1, "expert": 1,
                     "seq": 1},
            "remat": False,
            "pipeline_microbatches": 0,
            "zero_stage": 0,
            "device_image_cache": "auto",
            "device_image_cache_budget_gb": 0,
            "device_image_cache_layout": "replicated",
            "grad_accum_steps": 1,
            "prefetch_depth": 2,
            "use_pallas": True,
            "debug_nans": False,
            "prng_impl": "rbg",
            "profile_dir": "",
        },
    }


def _config_eval() -> Dict[str, Any]:
    """``config_eval.yaml``: dropout 0.4, stride 2, '*' fusion, 2 epochs."""
    cfg = _config()
    cfg["main"]["experiment_name_prefix"] = "my_exp"
    for size in ("full", "small"):
        cfg["main"][size]["paths"]["logs"] = "logs/"
    train = cfg["train"]
    for part in ("text", "image", "attention", "classifier"):
        train[part]["dropout"] = 0.4
    train["image"]["stride"] = 2
    train["attention"]["do_option"] = "*"
    train["n_epochs_stop"] = 6
    train["num_epochs"] = 2
    train["lr"]["lr_value"] = 1.0e-3
    return cfg


def _variant(prefix: str, **train) -> Dict[str, Any]:
    cfg = _config()
    cfg["main"]["experiment_name_prefix"] = prefix
    for dotted, value in train.items():
        node = cfg["train"]
        keys = dotted.split("__")
        for key in keys[:-1]:
            node = node[key]
        node[keys[-1]] = value
    return cfg


PRESETS = {
    "config": _config,
    "config_eval": _config_eval,
    "config_san": lambda: _variant("san_model", attention__variant="stacked"),
    "config_transformer_co": lambda: _variant(
        "transformer_co_model", text__encoder="transformer",
        attention__variant="co", max_answers=10000, batch_size=512),
    "config_vit": lambda: _variant(
        "vit_model", image__encoder="vit", image__num_channels=[3, 256],
        batch_size=512),
    "config_vit_moe": lambda: _variant(
        "vit_moe_model", image__encoder="vit", image__num_channels=[3, 256],
        image__moe_experts=8, batch_size=512),
}


def preset(name: str) -> Dict[str, Any]:
    """A fresh copy of the preset ``name`` (``config``, ``config_eval``,
    ``config_san``, ``config_transformer_co``, ``config_vit``,
    ``config_vit_moe``)."""
    if name.endswith(".yaml"):
        name = name[:-len(".yaml")]
    if name not in PRESETS:
        raise ValueError(
            f"unknown config preset {name!r}; the port carries "
            f"{sorted(PRESETS)} (YAML files are not read: PyYAML is not "
            "assured on the card)")
    return copy.deepcopy(PRESETS[name]())
