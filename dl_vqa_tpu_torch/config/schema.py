"""Config schema: a nested tree of expected types.

The port's copy of ``dl_vqa_tpu/config/schema.py`` (held to it by
``tests/test_torch_copies.py``): every key of the schema must be present
with the right type, and a key outside it is an error.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["CFG_SCHEMA", "validate", "SchemaError"]


class SchemaError(ValueError):
    pass


_PATHS = {
    "pretrained_model_path": str,
    "base_path": str,
    "logs": str,
    "vocab_path": str,
}

_SPLIT_PATHS = {
    "vqaDataset": str,
    "questions": str,
    "answers": str,
    "imgs": str,
    "processed_imgs": str,
}

_PROFILE = {
    "paths": _PATHS,
    "train_paths": _SPLIT_PATHS,
    "val_paths": _SPLIT_PATHS,
}

CFG_SCHEMA: Dict[str, Any] = {
    "main": {
        "experiment_name_prefix": str,
        "seed": int,
        "num_workers": int,
        "use_full": bool,
        "start_from_pretrained_model": bool,
        "full": _PROFILE,
        "small": _PROFILE,
    },
    "train": {
        "text": {
            "encoder": str,
            "question_features": int,
            "embedding_features": int,
            "dropout": float,
            "num_lstm_layers": int,
            "bidirectional": bool,
            "num_heads": int,
            "num_layers": int,
            "max_positions": int,
        },
        "image": {
            "encoder": str,
            "kernel_size": int,
            "dropout": float,
            "num_channels": list,
            "stride": int,
            "do_skip_connection": bool,
            "patch_size": int,
            "num_layers": int,
            "num_heads": int,
            "store_dtype": str,
            "moe_experts": int,
            "moe_top_k": int,
            "moe_capacity_factor": float,
            "moe_aux_weight": float,
        },
        "attention": {
            "variant": str,
            "hidden_dim": int,
            "glimpses": int,
            "do_option": str,
            "dropout": float,
        },
        "classifier": {
            "hidden_dim": int,
            "dropout": float,
        },
        "max_answers": int,
        "image_size": int,
        "central_fraction": float,
        "n_epochs_stop": int,
        "num_epochs": int,
        "batch_size": int,
        "save_model": bool,
        "lr": {
            "lr_value": float,
            "lr_decay": int,
            "lr_gamma": float,
            "lr_step_size": int,
        },
    },
    "tpu": {
        "compute_dtype": str,
        "online_images": bool,
        "native_loader": bool,
        "image_builder_backend": str,
        "mesh": {
            "data": int,
            "model": int,
            "stage": int,
            "expert": int,
            "seq": int,
        },
        "pipeline_microbatches": int,
        "zero_stage": int,
        "remat": bool,
        "grad_accum_steps": int,
        # bool too: the override parser reads bare on/off as booleans
        "device_image_cache": (str, bool),
        "device_image_cache_budget_gb": (float, int),
        "device_image_cache_layout": str,
        "checkpoint_backend": str,
        "checkpoint_every_steps": int,
        "prefetch_depth": int,
        "use_pallas": bool,
        "debug_nans": bool,
        "prng_impl": str,
        "profile_dir": str,
    },
}


def validate(
    cfg: Dict[str, Any],
    schema: Optional[Dict[str, Any]] = None,
    path: str = "",
) -> None:
    """Recursively validate ``cfg`` against the schema tree.

    Raises :class:`SchemaError` on missing keys, unexpected keys, or type
    mismatches. ``float`` slots accept ints (YAML '0' for a 0.0 field).
    """
    schema = CFG_SCHEMA if schema is None else schema
    missing = set(schema) - set(cfg)
    extra = set(cfg) - set(schema)
    if missing:
        raise SchemaError(f"Missing config keys at '{path}': {sorted(missing)}")
    if extra:
        raise SchemaError(f"Unexpected config keys at '{path}': {sorted(extra)}")
    for key, expected in schema.items():
        value = cfg[key]
        where = f"{path}.{key}" if path else key
        if isinstance(expected, dict):
            if not isinstance(value, dict):
                raise SchemaError(f"'{where}' must be a mapping")
            validate(value, expected, where)
        elif expected is float:
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                raise SchemaError(f"'{where}' must be a number, got {value!r}")
        elif expected is int:
            if not isinstance(value, int) or isinstance(value, bool):
                raise SchemaError(f"'{where}' must be an int, got {value!r}")
        elif expected is bool:
            if not isinstance(value, bool):
                raise SchemaError(f"'{where}' must be a bool, got {value!r}")
        elif expected is list:
            if not isinstance(value, list):
                raise SchemaError(f"'{where}' must be a list, got {value!r}")
        elif expected is str:
            if not isinstance(value, str):
                raise SchemaError(f"'{where}' must be a string, got {value!r}")
        elif isinstance(expected, tuple):
            if not isinstance(value, expected):
                names = "/".join(t.__name__ for t in expected)
                raise SchemaError(
                    f"'{where}' must be {names}, got {value!r}"
                )
        else:  # pragma: no cover - schema authoring error
            raise SchemaError(f"Bad schema entry at '{where}': {expected!r}")
