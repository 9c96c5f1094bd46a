"""Train logger: console, file, TensorBoard and the best-model checkpoint.

The port's copy of ``dl_vqa_tpu/utils/logger.py::TrainLogger``: a
timestamped experiment dir under ``logs_dir``, claimed atomically (two
runs started in one second get two dirs, with a suffix), a ``.log`` file
beside the console, TensorBoard through ``tensorboardX`` when it is
installed and a no-op writer otherwise, the same scalar tags, and
``save_model`` writing ``model.ckpt`` in the experiment dir; and
:class:`QuietLogger`, what the other processes of a multi-process run
hold in its place: only the coordinator writes (JAX ``logger.py:76``).
"""

from __future__ import annotations

import itertools
import logging
import os
from datetime import datetime
from typing import Dict, Optional

__all__ = ["TrainLogger", "QuietLogger"]


class _NoOpWriter:
    def add_scalar(self, *a, **k): pass
    def add_scalars(self, *a, **k): pass
    def add_hparams(self, *a, **k): pass
    def flush(self): pass
    def close(self): pass


class QuietLogger:
    """The TrainLogger surface for a process other than the coordinator:
    no experiment dir, no files, no TensorBoard; warnings reach stderr
    prefixed with the rank (every rank's info lines too where
    ``DL_VQA_LOG_ALL_HOSTS`` is set, to find which rank stopped). The loop
    gates its writes on the coordinator, so ``save_model`` raises."""

    exp_dir = None
    exp_name = None
    checkpoint_backend = "npz"

    def __init__(self, rank: int = 0):
        self._prefix = f"[rank {rank}] "
        self._verbose = bool(os.environ.get("DL_VQA_LOG_ALL_HOSTS"))

    def write(self, text, epoch=None, severity: str = "info") -> None:
        if severity == "warning" or self._verbose:
            log = f"(EPOCH {epoch}) {text}" if epoch is not None else text
            tag = "" if severity == "warning" else "[info] "
            logging.getLogger(__name__).warning(self._prefix + tag + str(log))

    def write_epoch_statistics(self, *a, **k): pass
    def report_scalar(self, *a, **k): pass
    def report_scalars(self, *a, **k): pass
    def report_scalar_same_plot(self, *a, **k): pass
    def report_scalars_same_plot(self, *a, **k): pass
    def report_metrics_hyper_params(self, *a, **k): pass

    def save_model(self, *a, **k):
        raise RuntimeError("QuietLogger writes no checkpoint: gate saves on "
                           "parallel.multihost.is_coordinator()")

    def close(self): pass


class TrainLogger:
    def __init__(self, exp_name_prefix: str = "", logs_dir: str = "logs",
                 checkpoint_backend: str = "npz"):
        if checkpoint_backend != "npz":
            raise NotImplementedError(
                f"checkpoint_backend={checkpoint_backend!r}: "
                "dl_vqa_tpu_torch writes npz checkpoints only (the Orbax "
                "backend is left behind, see ROADMAP)")
        self.checkpoint_backend = checkpoint_backend
        os.makedirs(logs_dir, exist_ok=True)
        now = datetime.now()
        stamp = f"{now.month}_{now.day}_{now.hour}_{now.minute}_{now.second}"
        self.exp_name = f"{exp_name_prefix}_{stamp}"
        self.exp_dir = os.path.join(logs_dir, self.exp_name)
        # The stamp has one-second resolution: claim the directory
        # atomically and suffix on collision, so two runs never share a
        # log file or a model.ckpt.
        for attempt in range(1000):
            candidate = (self.exp_dir if attempt == 0
                         else f"{self.exp_dir}_{attempt}")
            try:
                os.makedirs(candidate, exist_ok=False)
            except FileExistsError:
                continue
            if attempt:
                self.exp_name = f"{self.exp_name}_{attempt}"
            self.exp_dir = candidate
            break
        else:
            raise RuntimeError(
                f"could not claim a unique experiment dir under "
                f"{logs_dir!r} (1000 collisions for stamp {stamp})")

        try:
            from tensorboardX import SummaryWriter

            self.tensorboard_writer = SummaryWriter(
                os.path.join(logs_dir, "tensorboard", self.exp_name))
        except Exception:
            self.tensorboard_writer = _NoOpWriter()

        self.logger = self._init_logger(self.exp_dir, self.exp_name)

    def close(self) -> None:
        """Release the log handlers and the TensorBoard writer."""
        self.tensorboard_writer.close()
        for handler in list(self.logger.handlers):
            self.logger.removeHandler(handler)
            handler.close()

    def write(self, text: str, epoch: Optional[int] = None,
              severity: str = "info") -> None:
        log = f"(EPOCH {epoch}) {text}" if epoch is not None else str(text)
        if severity == "warning":
            self.logger.warning(log)
        else:
            self.logger.info(log)

    def write_epoch_statistics(self, epoch: int, epoch_time: float,
                               train_loss: float, norm: float,
                               train_score: float, eval_score: float) -> None:
        self.write(
            "Time: %.1f, Gradient norm: %.1f, Train loss: %.4f, "
            "Train Score: %.4f, Val score: %.4f"
            % (epoch_time, norm, train_loss, train_score, eval_score),
            epoch)

    def report_scalar(self, tag: str, value: float, step: int) -> None:
        self.tensorboard_writer.add_scalar(tag, value, step)

    def report_scalars(self, scalars: Dict[str, float], epoch: int) -> None:
        for tag, value in scalars.items():
            self.report_scalar(tag, value, epoch)

    def report_scalar_same_plot(self, tag: str, values: Dict[str, float],
                                step: int) -> None:
        self.tensorboard_writer.add_scalars(tag, values, step)

    def report_scalars_same_plot(self, scalars: Dict[str, Dict[str, float]],
                                 epoch: int) -> None:
        for tag, values in scalars.items():
            self.report_scalar_same_plot(tag, values, epoch)

    def report_metrics_hyper_params(self, hyper_params: Dict,
                                    metrics: Dict) -> None:
        self.tensorboard_writer.add_hparams(hyper_params, metrics)

    def save_model(self, state, epoch: int, model_cfg=None,
                   extra_meta=None) -> str:
        """Write the best-model checkpoint, ``model.ckpt`` in the
        experiment dir (the train loop gates it on the best eval score)."""
        from dl_vqa_tpu_torch.utils import checkpoint as ckpt

        path = os.path.join(self.exp_dir, "model.ckpt")
        self.write(f"Saving model to {path}")
        ckpt.save_checkpoint(path, state, epoch=epoch, model_cfg=model_cfg,
                             extra_meta=extra_meta)
        return path

    # One logging channel per logger, though two may share a name.
    _seq = itertools.count()

    @classmethod
    def _init_logger(cls, exp_dir: str, exp_name: str) -> logging.Logger:
        logger = logging.getLogger(f"TRAIN.{exp_name}.{next(cls._seq)}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        formatter = logging.Formatter(
            f"[%(asctime)s] [TRAIN.{exp_name}] - %(message)s")
        console = logging.StreamHandler()
        console.setFormatter(formatter)
        logger.addHandler(console)
        fileh = logging.FileHandler(os.path.join(exp_dir, f"{exp_name}.log"))
        fileh.setFormatter(formatter)
        logger.addHandler(fileh)
        return logger
