"""Train entry point of the port.

The counterpart of the root ``main.py``: config, logger, seed, the vocab,
the dataset caches and the device image table built or loaded, the model
from the seed, the optional warm start, the train loop and the hparam and
metric report. On the GPU unless the caller of :func:`main` passes
``device="cpu"``:

    python -m dl_vqa_tpu_torch.main [preset] [overrides...]
    python -m dl_vqa_tpu_torch.main main.use_full=false train.num_epochs=2
    python -m dl_vqa_tpu_torch.main -m [preset] train.image.stride=1,2 \
        [--trials N] [overrides...]

The first argument without ``=`` names a preset (``config_san``, ...; the
port carries them as dicts). ``-m`` (``--multirun``) sweeps, as Hydra's
multirun does (:func:`multirun_main`). Settings the port does not have
yet raise at once, naming their ROADMAP item: ``tpu.online_images`` and
``tpu.native_loader`` (the online JPEG pipeline), ``tpu.checkpoint_backend=
orbax``, mesh axes other than one device, ``tpu.zero_stage``,
``tpu.pipeline_microbatches``, ``tpu.debug_nans`` and ``tpu.profile_dir``.
``tpu.use_pallas`` and ``tpu.prng_impl`` choose between JAX
implementations and mean nothing here. ``train.image.store_dtype=f8e4m3``
trains through the f8 store's straight-through backward; ``int8`` serves
only, and the model refuses it in training as the JAX model does.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

import torch

from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["main", "multirun_main", "check_supported", "compute_dtype_of",
           "parameter_summary"]


def check_supported(cfg: dict) -> None:
    """Raise ``NotImplementedError`` for a setting the port lacks."""
    tpu = cfg["tpu"]
    missing = []
    if tpu["online_images"] or tpu["native_loader"]:
        missing.append("tpu.online_images / tpu.native_loader (the online "
                       "JPEG pipeline and preprocess_images: ROADMAP queue "
                       "1, item 3's remainder)")
    if tpu["checkpoint_backend"] != "npz":
        missing.append(f"tpu.checkpoint_backend="
                       f"{tpu['checkpoint_backend']!r} (npz only: the Orbax "
                       "backend is left behind, ROADMAP queue 1)")
    mesh = tpu["mesh"]
    if (mesh["data"] not in (-1, 1)
            or any(mesh[axis] != 1 for axis in ("model", "stage", "expert",
                                                "seq"))
            or tpu["zero_stage"] != 0 or tpu["pipeline_microbatches"] != 0):
        missing.append(f"tpu.mesh={mesh}, tpu.zero_stage="
                       f"{tpu['zero_stage']}, tpu.pipeline_microbatches="
                       f"{tpu['pipeline_microbatches']} (one device only: "
                       "the parallel axes are ROADMAP queue 1, item 9)")
    if tpu["debug_nans"]:
        missing.append("tpu.debug_nans (ROADMAP queue 1, item 3's remainder)")
    if tpu["profile_dir"]:
        missing.append("tpu.profile_dir (profile traces: ROADMAP queue 1, "
                       "item 3's remainder)")
    if tpu["image_builder_backend"] not in ("auto", "native", "pil"):
        raise ValueError(f"unknown builder backend: "
                         f"{tpu['image_builder_backend']!r}")
    if missing:
        raise NotImplementedError(
            "not ported to dl_vqa_tpu_torch yet: " + "; ".join(missing))


def compute_dtype_of(cfg: dict) -> torch.dtype:
    name = cfg["tpu"]["compute_dtype"]
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"tpu.compute_dtype must be 'bfloat16' or "
                         f"'float32', got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def parameter_summary(model: torch.nn.Module) -> str:
    """Parameter counts by part of the model (text, image, attention,
    classifier) and in all."""
    counts = {}
    for name, p in model.named_parameters():
        part = name.split(".")[0]
        counts[part] = counts.get(part, 0) + p.numel()
    lines = [f"{part}: {n:,} parameters" for part, n in counts.items()]
    return "\n".join(lines + [f"total: {sum(counts.values()):,} parameters"])


def main(cfg: dict, device=DEFAULT_DEVICE) -> float:
    """Train with the composed config ``cfg``; returns the best validation
    accuracy (``Metrics/BestAccuracy``)."""
    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.data import vocab as vocab_mod
    from dl_vqa_tpu_torch.data.dataset import (
        StaleImageCacheError, VQADataset, require_image_store)
    from dl_vqa_tpu_torch.data.device_cache import plan_image_tables
    from dl_vqa_tpu_torch.data.pipeline import Batcher
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.train.loop import TrainParams, train
    from dl_vqa_tpu_torch.utils import misc
    from dl_vqa_tpu_torch.utils.logger import TrainLogger

    device = resolve_device(device)
    misc.init(cfg)
    check_supported(cfg)
    compute_dtype = compute_dtype_of(cfg)
    profile = cfg["main"]["full" if cfg["main"]["use_full"] else "small"]
    seed = cfg["main"]["seed"]

    logger = TrainLogger(
        exp_name_prefix=cfg["main"]["experiment_name_prefix"],
        logs_dir=profile["paths"]["logs"],
        checkpoint_backend=cfg["tpu"]["checkpoint_backend"])
    logger.write(f"Device: {device}"
                 + (f" ({torch.cuda.get_device_name(device)})"
                    if device.type == "cuda" else ""))
    logger.write(json.dumps(cfg, indent=1))
    misc.set_seed(seed)

    vocab_path = profile["paths"]["vocab_path"]
    if not os.path.exists(vocab_path):
        logger.write("Creating Vocab")
        vocab_mod.create_vocab(
            data_base_path=profile["paths"]["base_path"],
            data_paths=profile["train_paths"], vocab_path=vocab_path,
            max_answers=cfg["train"]["max_answers"])
    for split in ("train_paths", "val_paths"):
        require_image_store(profile[split]["processed_imgs"])

    def load_or_build(split: str, answerable_only: bool) -> VQADataset:
        cache = VQADataset.cache_path(profile[split]["vqaDataset"])
        if os.path.exists(cache):
            try:
                loaded = VQADataset.load(cache)
            except (KeyError, StaleImageCacheError) as e:
                logger.write(f"Rebuilding stale cache {cache}: {e}")
            else:
                if loaded.has_image_rows:
                    logger.write(f"Loading VQA {split} dataset from {cache}")
                    return loaded
                logger.write(f"Cache {cache} has no image rows; rebuilding")
        else:
            logger.write(f"Creating {split} dataset")
        ds = VQADataset(data_paths=profile[split],
                        other_paths=profile["paths"], logger=logger,
                        answerable_only=answerable_only)
        ds.save(cache)
        return ds

    train_dataset = load_or_build("train_paths", answerable_only=True)
    val_dataset = load_or_build("val_paths", answerable_only=False)

    model_cfg = ModelConfig.from_cfg(cfg["train"], train_dataset.num_tokens,
                                     use_pallas=cfg["tpu"]["use_pallas"])
    model = VqaNet(model_cfg, device=device,
                   generator=torch.Generator().manual_seed(seed))

    opt_restore_path = None
    if cfg["main"]["start_from_pretrained_model"]:
        from dl_vqa_tpu_torch.utils.checkpoint import load_params
        from dl_vqa_tpu_torch.utils.params import load_jax_params

        pretrained = profile["paths"]["pretrained_model_path"]
        if pretrained.endswith((".pth", ".pt")):
            load_jax_params(model, load_params(pretrained))
            logger.write(f"Loaded torch params from {pretrained}")
        else:
            opt_restore_path = pretrained  # the full state, Adam included
    logger.write(parameter_summary(model))

    tables = plan_image_tables(
        cfg, {"train": train_dataset, "val": val_dataset}, device,
        log=logger.write)
    batch_size = cfg["train"]["batch_size"]
    train_batcher = Batcher(train_dataset, batch_size, shuffle=True,
                            seed=seed, load_images=tables["train"] is None)
    val_batcher = Batcher(val_dataset, batch_size,
                          load_images=tables["val"] is None)

    metrics = train(
        model_cfg, model, train_batcher, val_batcher,
        TrainParams.from_cfg(cfg), logger,
        opt_restore_path=opt_restore_path, compute_dtype=compute_dtype,
        seed=seed, prefetch_depth=cfg["tpu"]["prefetch_depth"],
        profile_dir=cfg["tpu"]["profile_dir"], remat=cfg["tpu"]["remat"],
        accum_steps=cfg["tpu"]["grad_accum_steps"],
        train_image_table=tables["train"], eval_image_table=tables["val"],
        checkpoint_every_steps=cfg["tpu"]["checkpoint_every_steps"])

    logger.report_metrics_hyper_params(config_mod.flatten(cfg["train"]),
                                       metrics)
    result = float(metrics["Metrics/BestAccuracy"])
    logger.close()
    return result


def multirun_main(config_name: str, args, runner=None,
                  max_trials: Optional[int] = None,
                  device=DEFAULT_DEVICE) -> float:
    """Hydra-style multirun: comma-valued overrides span the search space
    (``train.image.stride=1,2``), single-valued ones apply to every trial;
    bracketed values (``key=[3, 8]``) are single list values, as in Hydra's
    choice-sweep convention. Maximizes :func:`main`'s returned best
    accuracy through :mod:`dl_vqa_tpu_torch.sweep` with
    the reference sweeper's early stop; each trial trains on ``device``
    unless ``runner`` (``overrides -> value``) replaces the trial.

    By default every combination runs (Hydra's basic sweeper); ``--trials
    N`` among the args caps the budget, and the sweep then switches to
    TPE where the space exceeds it (the Ax plugin's behaviour). Returns the
    best value."""
    from dl_vqa_tpu_torch.sweep import (
        parse_space, run_sweep, space_size, trial_runner)

    args = list(args)
    if max_trials is None and "--trials" in args:
        at = args.index("--trials")
        try:
            max_trials = int(args[at + 1])
        except (IndexError, ValueError):
            raise SystemExit("--trials needs an integer, e.g. --trials 8")
        del args[at:at + 2]

    def _is_choice(a):
        if "=" not in a:
            raise SystemExit(
                f"multirun (-m) overrides must be key=value; got {a!r}")
        v = a.split("=", 1)[1].strip()
        return "," in v and not v.startswith(("[", "{"))

    space_args = [a for a in args if _is_choice(a)]
    base = [a for a in args if a not in space_args]
    if not space_args:
        raise SystemExit(
            "multirun (-m) needs at least one comma-valued override, "
            "e.g. train.image.stride=1,2")
    if max_trials is None:
        max_trials = space_size(parse_space(space_args))
    if runner is None:
        runner = trial_runner(config_name, device)
    _, best, _ = run_sweep(parse_space(space_args), max_trials=max_trials,
                           base_overrides=base, runner=runner)
    return best


def _cli(args) -> float:
    from dl_vqa_tpu_torch import config as config_mod

    multirun = bool(args) and args[0] in ("-m", "--multirun")
    if multirun:
        args = args[1:]
    config_name = "config"
    if args and "=" not in args[0]:
        config_name, args = args[0], args[1:]
    if multirun:
        return multirun_main(config_name, args)
    return main(config_mod.compose(config_name, overrides=args))


if __name__ == "__main__":
    print(_cli(sys.argv[1:]))
