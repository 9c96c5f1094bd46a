"""Evaluation entry point of the port.

The counterpart of the root ``evaluate_vqa.py``: compose the
``config_eval`` preset with the overrides, build the vocab if it is
missing, load or build the val dataset, load the checkpoint (an npz
checkpoint of either package, or a reference ``model.pth``), run the full
eval pass with the per-type breakdown, and return the VQA accuracy rounded
to 3 decimals. On the GPU unless the caller of :func:`evaluate_hw2`
passes ``device="cpu"``:

    python -m dl_vqa_tpu_torch.evaluate_vqa [overrides...]

As there, the model is built from the config, not from the checkpoint's
metadata: overrides must describe the trained model (``config_eval`` has
stride 2 and the '*' fusion). ``train.image.store_dtype`` scores a
quantized serving mode: ``f8e4m3`` as it is; ``int8`` with the scales in
the checkpoint's metadata where it carries them, else calibrated on up to
256 images of the train split's store, taken evenly by ``linspace``
(val images, with a caveat in the log, only where there is no train
store), as the JAX entry point does. A missing val store is built from its
JPEG directory; ``tpu.online_images`` decodes the val JPEGs by id instead
(``tpu.native_loader`` with it insists on libjpeg), and then int8 with
neither scales nor a train store raises, as there. ``tpu.profile_dir`` and
``tpu.debug_nans`` are train settings, which this entry point ignores as
the JAX one does. The settings :func:`dl_vqa_tpu_torch.main.
check_supported` refuses are not ported.
"""

from __future__ import annotations

import json
import os
import sys

from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["evaluate_hw2"]

CALIBRATION_IMAGES = 256


def _int8_scales(model_cfg, model, ckpt_meta, profile, val_dataset,
                 compute_dtype, log, online_images=False):
    """``model_cfg`` with the int8 mode's scales: a calibrate-once
    checkpoint's own (the numerics its deployment serves), else calibrated
    on train images, so that the val images being scored do not choose the
    served configuration."""
    import numpy as np

    from dl_vqa_tpu_torch.data.dataset import open_image_store

    adopted = model_cfg.with_checkpoint_scales(ckpt_meta)
    if adopted.image.quant_scales:
        log("int8 stem: using calibrated scales from checkpoint metadata: "
            f"{adopted.image.quant_scales}")
        return adopted
    store = profile["train_paths"]["processed_imgs"]
    if not os.path.isabs(store):
        store = os.path.join(profile["paths"]["base_path"], store)
    if os.path.exists(store):
        feats = open_image_store(store)
        rows = np.unique(np.linspace(
            0, feats.shape[0] - 1, min(feats.shape[0], CALIBRATION_IMAGES)
        ).astype(np.int64))
        cal = np.asarray(feats[rows]).transpose(0, 2, 3, 1)
        source = f"{len(rows)} train-cache images"
    else:
        if online_images:
            raise ValueError(
                "train.image.store_dtype=int8 auto-calibration reads a "
                "processed image store; build one (run with "
                "tpu.online_images=false), use a calibrate-once checkpoint "
                "(predict.Predictor.calibrate_int8 save_to=...), or set "
                "image.quant_scales programmatically")
        n_cal = min(len(val_dataset), CALIBRATION_IMAGES)
        rows = np.linspace(0, len(val_dataset) - 1, n_cal).astype(np.int64)
        cal = val_dataset.load_images_nhwc(rows)
        source = (f"{n_cal} VAL images (no train cache at {store!r} — score "
                  "may be optimistic vs a train-calibrated deployment)")
    model_cfg = model.int8_calibrated(cal, dtype=compute_dtype)
    log(f"int8 stem: calibrated activation scales over {source}: "
        f"{model_cfg.image.quant_scales}")
    return model_cfg


def evaluate_hw2(overrides=(), device=DEFAULT_DEVICE) -> float:
    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.data import vocab as vocab_mod
    from dl_vqa_tpu_torch.data.dataset import load_or_build_val_dataset
    from dl_vqa_tpu_torch.data.device_cache import plan_image_tables
    from dl_vqa_tpu_torch.data.pipeline import Batcher
    from dl_vqa_tpu_torch.main import check_supported, compute_dtype_of
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train import make_eval_step
    from dl_vqa_tpu_torch.train.loop import evaluate
    from dl_vqa_tpu_torch.utils import misc
    from dl_vqa_tpu_torch.utils.checkpoint import load_params
    from dl_vqa_tpu_torch.utils.logger import TrainLogger
    from dl_vqa_tpu_torch.utils.params import load_jax_params

    device = resolve_device(device)
    cfg = config_mod.compose("config_eval", overrides=list(overrides))
    check_supported(cfg)
    compute_dtype = compute_dtype_of(cfg)
    print(json.dumps(cfg, indent=1))
    profile = cfg["main"]["full" if cfg["main"]["use_full"] else "small"]

    logger = TrainLogger(
        exp_name_prefix=cfg["main"]["experiment_name_prefix"],
        logs_dir=profile["paths"]["logs"])
    misc.set_seed(cfg["main"]["seed"])

    vocab_path = profile["paths"]["vocab_path"]
    if not os.path.exists(vocab_path):
        vocab_mod.create_vocab(
            data_base_path=profile["paths"]["base_path"],
            data_paths=profile["train_paths"], vocab_path=vocab_path,
            max_answers=cfg["train"]["max_answers"])
    online_images = cfg["tpu"]["online_images"]
    val_dataset = load_or_build_val_dataset(
        cfg, profile, logger=logger, log=logger.write,
        require_image_cache=not online_images, device=device)

    model_cfg = ModelConfig.from_cfg(cfg["train"], val_dataset.num_tokens,
                                     use_pallas=cfg["tpu"]["use_pallas"])
    params, ckpt_meta = load_params(profile["paths"]["pretrained_model_path"],
                                    with_meta=True)
    model = load_jax_params(VqaNet(model_cfg, device=device), params)
    if (model_cfg.image.store_dtype == "int8"
            and not model_cfg.image.quant_scales):
        model_cfg = _int8_scales(model_cfg, model, ckpt_meta, profile,
                                 val_dataset, compute_dtype, logger.write,
                                 online_images)
        model.configure(model_cfg)
    eval_step = make_eval_step(model_cfg, compute_dtype, with_breakdown=True)
    if online_images:
        from dl_vqa_tpu_torch.data.online import (
            OnlineBatcher, loader_from_config)

        image_table = None
        batcher = OnlineBatcher(
            val_dataset, cfg["train"]["batch_size"],
            loader_from_config(cfg, profile, "val_paths", device,
                               logger.write))
    else:
        image_table = plan_image_tables(cfg, {"val": val_dataset}, device,
                                        log=logger.write)["val"]
        batcher = Batcher(val_dataset, cfg["train"]["batch_size"],
                          load_images=image_table is None)
    score, _, per_type = evaluate(
        eval_step, model, batcher, cfg["tpu"]["prefetch_depth"],
        breakdown=True, image_table=image_table)
    logger.write("Per-type accuracy: "
                 + ", ".join(f"{k}: {v:.2f}" for k, v in per_type.items()))
    logger.close()
    return round(score, 3)


if __name__ == "__main__":
    print(evaluate_hw2(sys.argv[1:]))
