"""Train state: the model, its optimizer and the count of updates done.

Port of ``dl_vqa_tpu/train/state.py``. The JAX state is an immutable
pytree that the jitted step donates and returns; here the step updates the
model's parameters and the optimizer's moments in place, and the state is
the one object that holds them.
"""

from __future__ import annotations

import torch

from dl_vqa_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["TrainState", "create_train_state"]


class TrainState:
    """``model``, ``optimizer`` (over the model's trainable parameters),
    ``initial_lr`` and ``step``, the number of optimizer updates done."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, initial_lr: float,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.initial_lr = float(initial_lr)
        self.step = int(step)


def create_train_state(model: torch.nn.Module, initial_lr: float, *,
                       device=DEFAULT_DEVICE) -> TrainState:
    """Move ``model`` to ``device`` (the GPU unless the caller passes
    another) and give it the reference's Adam."""
    from dl_vqa_tpu_torch.train.steps import make_optimizer

    model = model.to(resolve_device(device))
    return TrainState(model, make_optimizer(model, initial_lr), initial_lr)
