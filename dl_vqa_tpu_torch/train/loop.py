"""Epoch-level training loop.

The port's copy of ``dl_vqa_tpu/train/loop.py``: per epoch a train pass
and an eval pass, TensorBoard scalars, the best-model checkpoint gated on
the eval score, the rolling crash-recovery checkpoint ``last.ckpt`` at
every epoch's end and every ``checkpoint_every_steps`` batches, and the
early stop after ``n_epochs_stop`` stagnant epochs once ``epoch > 3``.

Metric accounting as there: the train and eval loss are means of
per-batch losses; the score is ``100 * sum(per-sample scores) /
len(dataset)``. Per-batch results are summed as device scalars and read
once an epoch (and at each mid-epoch save).

Resume: a rolling checkpoint continues its run (best score, early-stop
counter, last metrics, the epoch budget); one written mid-epoch resumes
that epoch at the next batch with its partial sums, and since the order
of an epoch derives from ``(seed, epoch)`` and the dropout masks from
``(seed, step)``, the resumed run takes the steps the uninterrupted run
takes. A best-model checkpoint or a reference ``.pth`` is a warm start
that retrains from epoch 0.

``profile_dir`` traces epoch index 1 (the first is dominated by warm-up,
as in the JAX loop) with ``torch.profiler`` (the CPU, and the card's
kernels and copies on CUDA) into one Chrome JSON file in ``profile_dir``.
``debug_nans`` (``tpu.debug_nans``; JAX's ``jax_debug_nans``) raises
``FloatingPointError`` at the first train or eval step whose outputs or
gradients hold a NaN, naming the step and the tensor or the backward
function: autograd's anomaly mode with its NaN check for the run (restored
after it), and a NaN check of each step's loss and score. Inf alone does
not raise; with the flag off nothing is checked.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import socket
import time
from typing import Dict, Optional

import torch

from dl_vqa_tpu_torch.data.pipeline import prefetch_to_device
from dl_vqa_tpu_torch.train.state import create_train_state
from dl_vqa_tpu_torch.train.steps import make_eval_step, make_train_step

__all__ = ["TrainParams", "train", "evaluate", "get_metrics",
           "EPOCH_SPAN", "PROFILED_EPOCH", "nan_guard", "check_nans"]

# The name of the profiler span around each epoch's train pass: a trace
# of a run reads the device's busy and idle time over an epoch from it.
EPOCH_SPAN = "dl_vqa_tpu_torch.train_epoch"
# The epoch index ``profile_dir`` traces: the second, as in the JAX loop.
PROFILED_EPOCH = 1


@contextlib.contextmanager
def nan_guard(enabled: bool, what: str):
    """Autograd's anomaly mode with its NaN check while the block (the
    step ``what``) runs, the previous setting restored after it: a
    backward function that returns NaN raises ``FloatingPointError``
    naming the step and the function. Nothing is set where ``enabled`` is
    false."""
    if not enabled:
        yield
        return
    previous = (torch.is_anomaly_enabled(),
                torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"tpu.debug_nans: {what}: {e}") from e
    finally:
        torch.autograd.set_detect_anomaly(*previous)


def check_nans(what: str, values: Dict[str, torch.Tensor]) -> None:
    """``FloatingPointError`` naming the step ``what`` and the first of
    ``values`` that holds a NaN (each is read: the device syncs)."""
    for name, value in values.items():
        if value is not None and bool(torch.isnan(value).any()):
            raise FloatingPointError(
                f"tpu.debug_nans: {what} returned NaN in its {name}")


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _write_trace(profiler, profile_dir: str, epoch: int) -> str:
    """Stop ``profiler`` and write its trace into ``profile_dir`` as a
    Chrome JSON file (the ``*.pt.trace.json`` name TensorBoard's profiler
    plugin lists)."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"epoch{epoch}_{socket.gethostname()}_"
                                     f"{os.getpid()}.pt.trace.json")
    profiler.export_chrome_trace(path)
    return path


@dataclasses.dataclass
class TrainParams:
    """Flat hyperparameter view of ``cfg['train']`` (lr_decay, lr_gamma and
    lr_step_size are carried for config parity and unused, as in the
    reference, whose StepLR is dead code)."""

    n_epochs_stop: int
    num_epochs: int
    lr: float
    lr_decay: float
    lr_gamma: float
    lr_step_size: int
    save_model: bool
    max_answers: int

    @classmethod
    def from_cfg(cls, cfg: Dict) -> "TrainParams":
        t = cfg["train"]
        return cls(
            n_epochs_stop=t["n_epochs_stop"],
            num_epochs=t["num_epochs"],
            lr=t["lr"]["lr_value"],
            lr_decay=t["lr"]["lr_decay"],
            lr_gamma=t["lr"]["lr_gamma"],
            lr_step_size=t["lr"]["lr_step_size"],
            save_model=t["save_model"],
            max_answers=t["max_answers"],
        )


def get_metrics(best_eval_score: float, eval_score: float,
                train_loss: float) -> Dict[str, float]:
    return {
        "Metrics/BestAccuracy": best_eval_score,
        "Metrics/LastAccuracy": eval_score,
        "Metrics/LastLoss": train_loss,
    }


def evaluate(eval_step, model, batcher, prefetch_depth: int = 2,
             breakdown: bool = False, image_table=None,
             debug_nans: bool = False):
    """Full eval pass -> ``(score %, mean loss)``, and with ``breakdown``
    (an eval step built ``with_breakdown=True``) a third value, ``{"yes/no":
    %, "number": %, "other": %}``. Sums run on the device; the totals are
    read once (with ``debug_nans``, each batch's loss and score are read
    too)."""
    device = next(model.parameters()).device
    n_batches = len(batcher)
    n_samples = len(batcher.dataset)
    loss_total = score_total = sums_total = counts_total = None
    for i, batch in enumerate(prefetch_to_device(iter(batcher), device,
                                                 prefetch_depth)):
        if image_table is not None:
            batch = dict(batch, image_table=image_table)
        out = eval_step(model, batch)
        loss, score = out[0], out[1]
        if debug_nans:
            check_nans(f"eval step {i}", {"loss": loss, "score": score})
        loss_total = loss if loss_total is None else loss_total + loss
        score_total = score if score_total is None else score_total + score
        if breakdown:
            sums, counts = out[2], out[3]
            sums_total = sums if sums_total is None else sums_total + sums
            counts_total = (counts if counts_total is None
                            else counts_total + counts)
    if loss_total is None:
        return (0.0, 0.0, {}) if breakdown else (0.0, 0.0)
    result = (float(score_total) / max(n_samples, 1) * 100.0,
              float(loss_total) / max(n_batches, 1))
    if breakdown:
        sums = sums_total.cpu().numpy()
        counts = counts_total.cpu().numpy()
        per_type = {
            name: float(s / c * 100.0)
            for name, s, c in zip(("yes/no", "number", "other"), sums, counts)
            if c > 0
        }
        return result + (per_type,)
    return result


def train(
    model_cfg,
    model: torch.nn.Module,
    train_batcher,
    eval_batcher,
    train_params: TrainParams,
    logger,
    opt_restore_path: Optional[str] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    seed: int = 1,
    prefetch_depth: int = 2,
    profile_dir: str = "",
    remat: bool = False,
    accum_steps: int = 1,
    train_image_table=None,
    eval_image_table=None,
    checkpoint_every_steps: int = 0,
    debug_nans: bool = False,
) -> Dict[str, float]:
    """Train ``model`` (a :class:`~dl_vqa_tpu_torch.models.vqa.VqaNet`, on
    the device it lies on) to the epoch budget or the early stop; returns
    the reference's metrics dict (``Metrics/BestAccuracy`` etc.). The
    LSTM's ``bias_hh``, where the model has an LSTM, is folded into
    ``bias_ih`` first (the same sum).

    ``checkpoint_every_steps > 0`` also writes ``last.ckpt`` every N
    batches within an epoch, with the batch position and the epoch's
    partial loss and score sums in its metadata; each such save reads the
    device sums (one sync every N steps)."""
    if not hasattr(train_batcher, "iter_epoch"):
        raise TypeError(
            "train_batcher needs iter_epoch(epoch, start_batch) (see "
            "data.pipeline.Batcher): a run resumes into an epoch through it")
    device = next(model.parameters()).device
    # The LSTM's fused bias in one tensor, as the checkpoints store it: a
    # resumed run then takes the steps the uninterrupted one takes. (The
    # transformer text encoder has no LSTM.)
    if hasattr(model.text, "lstm"):
        model.text.lstm.fold_biases()
    state = create_train_state(model, train_params.lr, device=device)
    best_eval_score = 0.0
    epochs_no_improve = 0
    start_epoch = 0
    resume_start_batch = 0
    resume_accum = None
    last_eval_score = 0.0
    last_train_loss = 0.0
    if opt_restore_path:
        from dl_vqa_tpu_torch.utils.checkpoint import restore_state_meta

        state, restore_meta = restore_state_meta(state, opt_restore_path)
        restored_epoch = restore_meta.get("epoch")
        logger.write(f"Restored full train state, epoch: {restored_epoch}")
        if "best_eval_score" in restore_meta:
            # A rolling checkpoint: continue the interrupted run.
            best_eval_score = float(restore_meta["best_eval_score"])
            epochs_no_improve = int(restore_meta.get("epochs_no_improve", 0))
            last_eval_score = float(restore_meta.get("last_eval_score", 0.0))
            last_train_loss = float(restore_meta.get("last_train_loss", 0.0))
            if restored_epoch is not None:
                if "batch_in_epoch" in restore_meta:
                    start_epoch = int(restored_epoch)
                    resume_start_batch = int(restore_meta["batch_in_epoch"])
                    resume_accum = restore_meta.get("epoch_accum") or {}
                else:
                    start_epoch = int(restored_epoch) + 1
            logger.write(
                f"Resuming at epoch {start_epoch}"
                + (f", batch {resume_start_batch}" if resume_start_batch
                   else "")
                + f" with best eval score {best_eval_score:.4f} "
                f"({epochs_no_improve} epochs without improvement)")

    train_step = make_train_step(model_cfg, compute_dtype, remat=remat,
                                 accum_steps=accum_steps)
    eval_step = make_eval_step(model_cfg, compute_dtype)

    # Seeded from the restore, so a run whose budget is already spent
    # reports its restored metrics.
    metrics = get_metrics(best_eval_score, last_eval_score, last_train_loss)
    if start_epoch >= train_params.num_epochs:
        logger.write(
            f"Restored run already completed its epoch budget "
            f"({start_epoch} >= num_epochs={train_params.num_epochs}); "
            f"nothing to train — reporting restored metrics")
    # The predictor encodes questions at the trained length.
    max_q_len = getattr(train_batcher.dataset, "max_question_length", None)
    ckpt_meta = {"max_question_length": int(max_q_len)} if max_q_len else None
    save_model = train_params.save_model
    if checkpoint_every_steps > 0 and not save_model:
        logger.write(
            "WARNING: tpu.checkpoint_every_steps="
            f"{checkpoint_every_steps} has no effect because "
            "train.save_model is false — no mid-epoch checkpoints will "
            "be written")

    def as_sum(value):
        return torch.tensor(value, dtype=torch.float32, device=device)

    for epoch in range(start_epoch, train_params.num_epochs):
        t0 = time.time()
        n_batches = len(train_batcher)
        n_samples = len(train_batcher.dataset)
        loss_total = score_total = aux_total = None
        start_batch = resume_start_batch if epoch == start_epoch else 0
        if start_batch and resume_accum is not None:
            if "loss" in resume_accum:
                loss_total = as_sum(resume_accum["loss"])
                score_total = as_sum(resume_accum.get("score", 0.0))
            if "aux" in resume_accum:
                aux_total = as_sum(resume_accum["aux"])
        epoch_iter = train_batcher.iter_epoch(epoch, start_batch)
        batch_idx = start_batch
        profiler = (_start_profiler(device)
                    if profile_dir and epoch == PROFILED_EPOCH else None)

        try:
            with torch.profiler.record_function(EPOCH_SPAN):
                for batch in prefetch_to_device(epoch_iter, device,
                                                prefetch_depth):
                    if train_image_table is not None:
                        batch = dict(batch, image_table=train_image_table)
                    what = (f"train step {state.step} (epoch {epoch}, "
                            f"batch {batch_idx})")
                    with nan_guard(debug_nans, what):
                        state, step_metrics = train_step(state, batch, seed)
                    loss, score = step_metrics["loss"], step_metrics["score"]
                    if debug_nans:
                        check_nans(what, {"loss": loss, "score": score})
                    loss_total = (loss if loss_total is None
                                  else loss_total + loss)
                    score_total = (score if score_total is None
                                   else score_total + score)
                    aux = step_metrics.get("moe_aux")
                    if aux is not None:
                        aux_total = (aux if aux_total is None
                                     else aux_total + aux)
                    batch_idx += 1
                    if (checkpoint_every_steps > 0 and save_model
                            and batch_idx % checkpoint_every_steps == 0
                            and batch_idx < n_batches):
                        # Position and partial sums ride the metadata; the
                        # float() reads sync the device.
                        epoch_accum = {"loss": float(loss_total),
                                       "score": float(score_total)}
                        if aux_total is not None:
                            epoch_accum["aux"] = float(aux_total)
                        _save_rolling(
                            logger, state, epoch, model_cfg, ckpt_meta,
                            best_eval_score, epochs_no_improve,
                            batch_in_epoch=batch_idx, epoch_accum=epoch_accum,
                            last_eval_score=last_eval_score,
                            last_train_loss=last_train_loss)
                # The reads wait for every queued step: inside the
                # epoch's time.
                train_loss = (float(loss_total) if loss_total is not None
                              else 0.0) / max(n_batches, 1)
                train_score = (float(score_total) if score_total is not None
                               else 0.0) / max(n_samples, 1) * 100.0
        except BaseException:
            if profiler is not None:  # a failed epoch writes no trace
                profiler.stop()
            raise

        epoch_seconds = max(time.time() - t0, 1e-9)
        if profiler is not None:
            _write_trace(profiler, profile_dir, epoch)
            logger.write(f"Profiler trace written to {profile_dir}")
        # A resumed epoch ran only its tail: rate that.
        batches_run = n_batches - start_batch
        samples_run = (
            n_samples - start_batch * train_batcher.batch_size
            if start_batch else n_samples)
        scalars = {
            "Throughput/StepsPerSec": batches_run / epoch_seconds,
            "Throughput/QAPairsPerSecPerChip": samples_run / epoch_seconds,
        }
        if aux_total is not None:
            # Expert balance of a MoE model: 1.0 at uniform routing.
            scalars["Loss/MoEBalanceTrain"] = (float(aux_total)
                                               / max(n_batches, 1))
        logger.report_scalars(scalars, epoch)

        eval_score, eval_loss = evaluate(
            eval_step, state.model, eval_batcher, prefetch_depth,
            image_table=eval_image_table, debug_nans=debug_nans)

        logger.write_epoch_statistics(
            epoch=epoch, epoch_time=time.time() - t0, train_loss=train_loss,
            norm=0, train_score=train_score, eval_score=eval_score)
        logger.report_scalars({
            "Accuracy/Train": train_score,
            "Accuracy/Validation": eval_score,
            "Loss/Train": train_loss,
            "Loss/Validation": eval_loss,
        }, epoch)
        logger.report_scalars_same_plot({
            "Accuracy": {"Train": train_score, "Validation": eval_score},
            "Loss": {"Train": train_loss, "Validation": eval_loss},
        }, epoch)

        if eval_score > best_eval_score:
            epochs_no_improve = 0
            best_eval_score = eval_score
            if save_model:
                logger.save_model(state, epoch, model_cfg,
                                  extra_meta=ckpt_meta)
        else:
            epochs_no_improve += 1

        last_eval_score = float(eval_score)
        last_train_loss = float(train_loss)

        if save_model:
            # The rolling checkpoint of a finished epoch: a restart starts
            # the next one.
            _save_rolling(logger, state, epoch, model_cfg, ckpt_meta,
                          best_eval_score, epochs_no_improve,
                          last_eval_score=last_eval_score,
                          last_train_loss=last_train_loss)

        metrics = get_metrics(best_eval_score, eval_score, train_loss)
        if epoch > 3 and epochs_no_improve == train_params.n_epochs_stop:
            logger.write("Early stopping!")
            return _finish(metrics)

    return _finish(metrics)


def _save_rolling(logger, state, epoch, model_cfg, ckpt_meta,
                  best_eval_score, epochs_no_improve, **extra_meta):
    """Write ``last.ckpt`` in the background, with the resume progress in
    its metadata (mid-epoch callers add ``batch_in_epoch`` and
    ``epoch_accum``)."""
    from dl_vqa_tpu_torch.utils import checkpoint as ckpt

    resume_meta = dict(ckpt_meta or {})
    resume_meta["best_eval_score"] = float(best_eval_score)
    resume_meta["epochs_no_improve"] = int(epochs_no_improve)
    resume_meta.update(extra_meta)
    ckpt.save_checkpoint_async(
        os.path.join(logger.exp_dir, "last.ckpt"), state, epoch=epoch,
        model_cfg=model_cfg, extra_meta=resume_meta)


def _finish(metrics):
    """Join the async checkpoint write in flight: ``last.ckpt`` is whole
    when train() returns."""
    from dl_vqa_tpu_torch.utils.checkpoint import wait_for_async_saves

    wait_for_async_saves()
    return metrics
