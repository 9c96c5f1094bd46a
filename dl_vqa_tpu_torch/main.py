"""Train entry point of the port.

The counterpart of the root ``main.py``: config, logger, seed, the vocab,
the dataset caches and the device image table built or loaded, the model
from the seed, the optional warm start, the train loop and the hparam and
metric report. On the GPU unless the caller of :func:`main` passes
``device="cpu"`` (``--device cpu`` on the command line):

    python -m dl_vqa_tpu_torch.main [--device D] [preset] [overrides...]
    python -m dl_vqa_tpu_torch.main main.use_full=false train.num_epochs=2
    python -m dl_vqa_tpu_torch.main -m [preset] train.image.stride=1,2 \
        [--trials N] [overrides...]

The first argument without ``=`` names a preset (``config_san``, ...; the
port carries them as dicts). ``-m`` (``--multirun``) sweeps, as Hydra's
multirun does (:func:`multirun_main`). A split's missing image store is
built from its JPEG directory (``tpu.image_builder_backend``) unless
``tpu.online_images`` decodes the JPEGs by id as batches are made
(:mod:`dl_vqa_tpu_torch.data.online`; ``tpu.native_loader`` with it
insists on libjpeg). ``tpu.profile_dir`` traces epoch 1 and
``tpu.debug_nans`` raises ``FloatingPointError`` at the first step that
returns a NaN (:func:`dl_vqa_tpu_torch.train.loop.train`).

Several GPUs train data-parallel, one process each, as torchrun launches
them (:mod:`dl_vqa_tpu_torch.parallel`):

    torchrun --nproc-per-node=N -m dl_vqa_tpu_torch.main [overrides...]
    torchrun --nnodes=M --node-rank=R --nproc-per-node=N \
        --master-addr=HOST --master-port=PORT -m dl_vqa_tpu_torch.main ...

Each process joins the group (NCCL on the GPU), the mesh's 'data' axis
takes every process left over by the other axes (``tpu.mesh.data=-1``),
the coordinator builds the caches while the others wait, each process
feeds its 'data' shard's rows of every global batch (``train.batch_size``
is the global batch), and ``tpu.zero_stage`` 1 or 3 splits the Adam
moments, or the parameters too, over the 'data' ranks.
``tpu.device_image_cache_layout=sharded`` splits the image table's rows
over them. ``tpu.mesh.model=M`` splits the classifier, the attention's
projections, the embedding's rows and the transformer blocks over M ranks
(tensor parallelism), and ``tpu.mesh.expert=X`` the experts of a ViT-MoE
over X (expert parallelism), as the JAX package's placement rules split
them (:mod:`dl_vqa_tpu_torch.parallel.tensor`):

    torchrun --nproc-per-node=2 -m dl_vqa_tpu_torch.main tpu.mesh.model=2
    torchrun --nproc-per-node=4 -m dl_vqa_tpu_torch.main config_vit_moe \
        tpu.mesh.expert=2 tpu.mesh.model=2

``tpu.mesh.seq=S`` splits a ViT's patch tokens over S ranks, attention
riding a ring over them (sequence parallelism,
:mod:`dl_vqa_tpu_torch.parallel.sequence`):

    torchrun --nproc-per-node=2 -m dl_vqa_tpu_torch.main config_vit \
        train.image_size=448 tpu.mesh.seq=2

``tpu.mesh.stage=P`` splits a ViT's blocks into P stages, one a rank,
through which ``tpu.pipeline_microbatches`` microbatches stream (0: one a
stage; GPipe, :mod:`dl_vqa_tpu_torch.parallel.pipeline`):

    torchrun --nproc-per-node=2 -m dl_vqa_tpu_torch.main config_vit \
        tpu.mesh.stage=2 tpu.pipeline_microbatches=4

Two ranks on one card need gloo (NCCL refuses two ranks on one device).

The axes compose as the JAX package composes them; what it refuses raises
its error: a CNN with ``tpu.mesh.seq`` or ``tpu.mesh.stage`` above 1,
'seq' with 'stage', and under 'stage' the int8 ViT and a ViT-MoE.
``tpu.checkpoint_backend=orbax`` raises at once, naming its ROADMAP
item, and so does ``fused_ops`` on the ViT with ``tpu.mesh.model`` above
1 (in the steps; the port's own option).
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

from dl_vqa_tpu_torch.parallel.sequence import check_sequence_parallel
from dl_vqa_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device, split_device_arg)

__all__ = ["main", "multirun_main", "check_supported", "compute_dtype_of",
           "parameter_summary"]


def check_supported(cfg: dict) -> None:
    """Raise ``NotImplementedError`` for a setting the port lacks,
    ``SystemExit`` for a ZeRO stage that does not exist, and the JAX
    model's ``ValueError`` for a CNN under 'seq'."""
    tpu = cfg["tpu"]
    missing = []
    if tpu["checkpoint_backend"] != "npz":
        missing.append(f"tpu.checkpoint_backend="
                       f"{tpu['checkpoint_backend']!r} (npz only: the Orbax "
                       "backend is left behind, ROADMAP queue 1)")
    check_sequence_parallel(tpu["mesh"]["seq"],
                            cfg["train"]["image"].get("encoder", "cnn"))
    if tpu["zero_stage"] not in (0, 1, 3):
        raise SystemExit(
            f"tpu.zero_stage must be 0 (off), 1 (shard Adam moments over "
            f"'data') or 3 (shard params too); got {tpu['zero_stage']!r}. "
            "Stage 2 does not exist here, as in the JAX package: the "
            "gradients live only inside the train step.")
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
        StaleImageCacheError, VQADataset, build_image_store)
    from dl_vqa_tpu_torch.data.device_cache import plan_image_tables
    from dl_vqa_tpu_torch.data.pipeline import Batcher
    from dl_vqa_tpu_torch.models.configs import ModelConfig
    from dl_vqa_tpu_torch.models.vqa import VqaNet
    from dl_vqa_tpu_torch.parallel import make_mesh, multihost
    from dl_vqa_tpu_torch.train.loop import TrainParams, train
    from dl_vqa_tpu_torch.utils import misc
    from dl_vqa_tpu_torch.utils.logger import QuietLogger, TrainLogger

    device = resolve_device(device)
    misc.init(cfg)
    check_supported(cfg)
    compute_dtype = compute_dtype_of(cfg)
    profile = cfg["main"]["full" if cfg["main"]["use_full"] else "small"]
    seed = cfg["main"]["seed"]
    zero_stage = cfg["tpu"]["zero_stage"]

    # A torchrun launch joins the group here (one process per GPU); one
    # process without torchrun's environment goes on alone.
    multihost.maybe_initialize(log=print, device=device)
    device = multihost.rank_device(device)
    if multihost.is_coordinator():
        logger = TrainLogger(
            exp_name_prefix=cfg["main"]["experiment_name_prefix"],
            logs_dir=profile["paths"]["logs"],
            checkpoint_backend=cfg["tpu"]["checkpoint_backend"])
    else:
        # The other ranks compute the same reduced metrics and write
        # nothing.
        import torch.distributed as dist

        logger = QuietLogger(dist.get_rank())
    logger.write(f"Device: {device}"
                 + (f" ({torch.cuda.get_device_name(device)})"
                    if device.type == "cuda" else ""))
    logger.write(json.dumps(cfg, indent=1))
    misc.set_seed(seed)
    mesh_cfg = cfg["tpu"]["mesh"]
    mesh = make_mesh(mesh_cfg["data"], mesh_cfg["model"], mesh_cfg["stage"],
                     mesh_cfg["expert"], mesh_cfg["seq"],
                     device_type=device.type)
    image = cfg["train"]["image"]
    if mesh_cfg["expert"] > 1 and (image.get("moe_experts", 0) < 1
                                   or image["encoder"] != "vit"):
        raise SystemExit(
            "tpu.mesh.expert > 1 needs train.image.encoder=vit with "
            "train.image.moe_experts > 0 (there are no expert-major "
            "parameters to shard otherwise)")
    if zero_stage and mesh.shape["data"] <= 1:
        logger.write(
            f"tpu.zero_stage={zero_stage} is a no-op: the 'data' mesh axis "
            f"has 1 device, so there is nothing to shard the optimizer "
            f"state over")

    # The coordinator builds the offline caches (a shared filesystem);
    # the others wait at the barrier and load them.
    vocab_path = profile["paths"]["vocab_path"]
    online_images = cfg["tpu"]["online_images"]
    if multihost.is_coordinator():
        if not os.path.exists(vocab_path):
            logger.write("Creating Vocab")
            vocab_mod.create_vocab(
                data_base_path=profile["paths"]["base_path"],
                data_paths=profile["train_paths"], vocab_path=vocab_path,
                max_answers=cfg["train"]["max_answers"])
        if not online_images:
            for split in ("train_paths", "val_paths"):
                build_image_store(cfg, profile, split, log=logger.write,
                                  device=device)

    def load_or_build(split: str, answerable_only: bool) -> VQADataset:
        cache = VQADataset.cache_path(profile[split]["vqaDataset"])
        if os.path.exists(cache):
            try:
                loaded = VQADataset.load(cache)
            except (KeyError, StaleImageCacheError) as e:
                logger.write(f"Rebuilding stale cache {cache}: {e}")
            else:
                if online_images or loaded.has_image_rows:
                    logger.write(f"Loading VQA {split} dataset from {cache}")
                    return loaded
                logger.write(f"Cache {cache} was built in online-image "
                             "mode; rebuilding with the store's row map")
        else:
            logger.write(f"Creating {split} dataset")
        ds = VQADataset(data_paths=profile[split],
                        other_paths=profile["paths"], logger=logger,
                        answerable_only=answerable_only,
                        require_image_cache=not online_images)
        ds.save(cache)
        return ds

    if multihost.is_coordinator():
        train_dataset = load_or_build("train_paths", answerable_only=True)
        val_dataset = load_or_build("val_paths", answerable_only=False)
    multihost.barrier("offline-caches-built")
    if not multihost.is_coordinator():
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

    batch_size = cfg["train"]["batch_size"]
    # Each process feeds its rows of every global batch.
    accum_steps = cfg["tpu"]["grad_accum_steps"]
    proc_slice = multihost.process_batch_slice(mesh, batch_size, accum_steps)
    # The eval step takes whole batches: one contiguous block a process.
    val_slice = multihost.process_batch_slice(mesh, batch_size)
    if online_images:
        from dl_vqa_tpu_torch.data.online import (
            OnlineBatcher, loader_from_config)

        # The batches carry their decoded JPEGs: no table, even where the
        # dataset has rows from an earlier run.
        tables = {"train": None, "val": None}
        train_batcher = OnlineBatcher(
            train_dataset, batch_size,
            loader_from_config(cfg, profile, "train_paths", device,
                               logger.write), shuffle=True, seed=seed,
            process_slice=proc_slice)
        val_batcher = OnlineBatcher(
            val_dataset, batch_size,
            loader_from_config(cfg, profile, "val_paths", device,
                               logger.write), process_slice=val_slice)
    else:
        tables = plan_image_tables(
            cfg, {"train": train_dataset, "val": val_dataset}, device,
            log=logger.write, mesh=mesh)
        train_batcher = Batcher(train_dataset, batch_size, shuffle=True,
                                seed=seed,
                                load_images=tables["train"] is None,
                                process_slice=proc_slice)
        val_batcher = Batcher(val_dataset, batch_size,
                              load_images=tables["val"] is None,
                              process_slice=val_slice)

    metrics = train(
        model_cfg, model, train_batcher, val_batcher,
        TrainParams.from_cfg(cfg), logger,
        opt_restore_path=opt_restore_path, compute_dtype=compute_dtype,
        seed=seed, prefetch_depth=cfg["tpu"]["prefetch_depth"],
        profile_dir=cfg["tpu"]["profile_dir"], remat=cfg["tpu"]["remat"],
        accum_steps=accum_steps,
        train_image_table=tables["train"], eval_image_table=tables["val"],
        checkpoint_every_steps=cfg["tpu"]["checkpoint_every_steps"],
        debug_nans=cfg["tpu"]["debug_nans"], mesh=mesh,
        zero_stage=zero_stage,
        microbatches=cfg["tpu"]["pipeline_microbatches"])

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

    device, args = split_device_arg(args)
    multirun = bool(args) and args[0] in ("-m", "--multirun")
    if multirun:
        args = args[1:]
    config_name = "config"
    if args and "=" not in args[0]:
        config_name, args = args[0], args[1:]
    if multirun:
        return multirun_main(config_name, args, device=device)
    return main(config_mod.compose(config_name, overrides=args),
                device=device)


if __name__ == "__main__":
    print(_cli(sys.argv[1:]))
