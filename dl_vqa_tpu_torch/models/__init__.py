"""Models of the port: the configuration dataclasses and VqaNet."""

from dl_vqa_tpu_torch.models.configs import ModelConfig
from dl_vqa_tpu_torch.models.vqa import VqaNet

__all__ = ["ModelConfig", "VqaNet"]
