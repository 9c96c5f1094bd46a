"""Config system of the port: preset dicts, dotlist overrides, schema."""

from dl_vqa_tpu_torch.config.core import (
    apply_overrides,
    compose,
    flatten,
    select,
)
from dl_vqa_tpu_torch.config.presets import PRESETS, preset
from dl_vqa_tpu_torch.config.schema import CFG_SCHEMA, SchemaError, validate

__all__ = ["apply_overrides", "compose", "flatten", "select", "PRESETS",
           "preset", "CFG_SCHEMA", "SchemaError", "validate"]
