"""The hard-task accuracy run: train the reference-parity model on the
fine-grained synthetic task, then score its best checkpoint in every
serving mode.

The recipe is ``experiments/probe_f8_accuracy.py --hard`` of the JAX
package, run through the port's own entry points:

1. the corpus: ``make_synthetic_corpus(learnable="hard")``, 20,000 train and
   4,000 val questions over 1,500 images at 224 px, 1,000 answers, from
   seed 0, as the JAX package's run (rendered into ``ROOT/corpus``);
2. for each seed of ``--seeds``: ``dl_vqa_tpu_torch.main`` with the
   ``config`` preset (``ModelConfig`` defaults, Adam 5e-4, batch 512,
   bf16, dropout 0.3, the device image table on), ``train.num_epochs=25
   train.max_answers=1000 main.seed=SEED``; it keeps the best
   checkpoint (``model.ckpt``);
3. that checkpoint scored by ``dl_vqa_tpu_torch.evaluate_vqa`` as
   ``compute``, as ``f8e4m3`` and as ``int8`` (calibrated on 256 train
   images), each with the training run's model configuration;
4. with ``--vit-seeds``, the same for the ViT of ``config_vit`` (no f8
   mode: the JAX model refuses it for the ViT).

Prints one JSON line a run: the seed, the model, the loop's best val score,
the three scores, the deltas against ``compute`` in percentage points, the
int8 scales, the seconds, and the device with its power limit. On the GPU:

    python -m dl_vqa_tpu_torch.tools.end_task [--root DIR] [--seeds 0,1]
        [--vit-seeds 0] [--epochs 25]

The flags that shrink the corpus exist for the CPU test (``--device
cpu``); the recipe's defaults are the run.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import time

__all__ = ["main", "eval_overrides"]

CORPUS_SEED = 0  # the corpus is the same for every training seed


def _value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_value(x) for x in v) + "]"
    if v is None:
        return "null"
    return str(v)


def eval_overrides(train_cfg: dict, eval_cfg: dict, prefix="train") -> list:
    """``key=value`` overrides that turn ``eval_cfg``'s ``train`` group into
    ``train_cfg``'s: the trained model's description for ``evaluate_vqa``
    (whose ``config_eval`` preset has stride 2 and the '*' fusion)."""
    out = []
    for key, value in train_cfg.items():
        dotted = f"{prefix}.{key}"
        if isinstance(value, dict) and isinstance(eval_cfg.get(key), dict):
            out += eval_overrides(value, eval_cfg[key], dotted)
        elif key not in eval_cfg:
            out.append(f"++{dotted}={_value(value)}")
        elif eval_cfg[key] != value:
            out.append(f"{dotted}={_value(value)}")
    return out


def _device_line(device) -> dict:
    if device.type != "cuda":
        return {"device": str(device)}
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi.stdout.strip()}


def main(argv=None) -> list:
    from dl_vqa_tpu_torch import config as config_mod
    from dl_vqa_tpu_torch.data.synthetic import make_synthetic_corpus
    from dl_vqa_tpu_torch.evaluate_vqa import evaluate_hw2
    from dl_vqa_tpu_torch.main import main as train_main
    from dl_vqa_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default="_end_task")
    parser.add_argument("--seeds", default="0,1")
    parser.add_argument("--vit-seeds", default="")
    parser.add_argument("--epochs", type=int, default=25)
    parser.add_argument("--n-train", type=int, default=20_000)
    parser.add_argument("--n-val", type=int, default=4_000)
    parser.add_argument("--n-images", type=int, default=1_500)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--max-answers", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--train-overrides", default="",
                        help="more overrides of the training run, "
                             "space-separated (the CPU test narrows the "
                             "model with them)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    root = os.path.abspath(args.root)

    t0 = time.perf_counter()
    corpus = os.path.join(root, "corpus")
    prof = make_synthetic_corpus(
        corpus, n_train=args.n_train, n_val=args.n_val,
        n_images=args.n_images, image_size=args.image_size,
        max_answers=args.max_answers, seed=CORPUS_SEED,
        learnable="hard")
    corpus_s = time.perf_counter() - t0
    paths = ["main.use_full=false"] + [
        f"main.small.{group}.{key}={value}"
        for group, entries in prof.items() for key, value in entries.items()]

    runs = [("cnn", "config", int(s)) for s in args.seeds.split(",") if s]
    runs += [("vit", "config_vit", int(s))
             for s in args.vit_seeds.split(",") if s]
    results = []
    for model, preset, seed in runs:
        prefix = f"end_task_{model}_s{seed}"
        logs = os.path.join(root, "logs", prefix) + "/"
        train_ov = paths + [
            f"main.experiment_name_prefix={prefix}", f"main.seed={seed}",
            f"main.small.paths.logs={logs}",
            f"train.num_epochs={args.epochs}",
            f"train.max_answers={args.max_answers}",
            f"train.image_size={args.image_size}",
            f"train.batch_size={args.batch_size}",
            "tpu.device_image_cache=on", "tpu.compute_dtype=bfloat16",
            *args.train_overrides.split()]
        cfg = config_mod.compose(preset, train_ov)
        t0 = time.perf_counter()
        best = train_main(cfg, device=device)
        train_s = time.perf_counter() - t0
        (exp_dir,) = glob.glob(os.path.join(logs, f"{prefix}_*"))
        ckpt = os.path.join(exp_dir, "model.ckpt")
        if not os.path.exists(ckpt):
            raise RuntimeError(
                f"{prefix}: no epoch scored above 0, so the loop kept no "
                "best checkpoint to score")
        described = eval_overrides(
            cfg["train"], config_mod.compose("config_eval", paths)["train"])
        scores, modes = {}, ["compute", "int8"]
        if model == "cnn":
            modes.insert(1, "f8e4m3")
        t0 = time.perf_counter()
        for mode in modes:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                scores[mode] = evaluate_hw2(
                    paths + described + [
                        f"main.small.paths.pretrained_model_path={ckpt}",
                        f"main.small.paths.logs={logs}eval_{mode}/",
                        f"train.image.store_dtype={mode}"], device=device)
        eval_s = time.perf_counter() - t0
        scales = None  # as the int8 evaluation logged them
        for path in glob.glob(os.path.join(logs, "eval_int8", "**", "*"),
                              recursive=True):
            if os.path.isfile(path):
                with open(path, errors="replace") as fd:
                    for line in fd:
                        if "activation scales" in line:
                            scales = line.rsplit(": ", 1)[-1].strip()
        result = {
            "end_task": model, "seed": seed, "epochs": args.epochs,
            "best_val": round(best, 3), "score_compute": scores["compute"],
            "score_f8e4m3": scores.get("f8e4m3"),
            "score_int8": scores["int8"],
            "delta_f8_pp": (round(scores["f8e4m3"] - scores["compute"], 3)
                            if "f8e4m3" in scores else None),
            "delta_int8_pp": round(scores["int8"] - scores["compute"], 3),
            "int8_scales": scales, "train_s": round(train_s, 1),
            "eval_s": round(eval_s, 1), "corpus_s": round(corpus_s, 1),
            "corpus": (f"hard, seed {CORPUS_SEED}, {args.n_train} train "
                       f"/ {args.n_val} val / {args.n_images} images @ "
                       f"{args.image_size} px, {args.max_answers} answers"),
            **_device_line(device)}
        print(json.dumps(result), flush=True)
        results.append(result)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
