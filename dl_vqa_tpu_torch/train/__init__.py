"""Training: the train state, the Adam step and the eval step."""

from dl_vqa_tpu_torch.train.state import TrainState, create_train_state
from dl_vqa_tpu_torch.train.steps import (
    lr_schedule,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = ["TrainState", "create_train_state", "lr_schedule",
           "make_optimizer", "make_train_step", "make_eval_step"]
