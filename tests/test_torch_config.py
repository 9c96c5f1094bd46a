"""The port's ModelConfig against the JAX package's, field by field."""

import dataclasses

import pytest

from dl_vqa_tpu import config as config_mod
from dl_vqa_tpu.models import configs as jax_configs
from dl_vqa_tpu_torch.models import configs as port_configs

CLASSES = ["TextConfig", "ImageConfig", "AttentionConfig", "ClassifierConfig",
           "ModelConfig"]


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _as_plain(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", CLASSES)
def test_defaults_equal_field_by_field(name):
    jax_cls = getattr(jax_configs, name)
    port_cls = getattr(port_configs, name)
    assert [f.name for f in dataclasses.fields(port_cls)] == \
        [f.name for f in dataclasses.fields(jax_cls)]
    assert _as_plain(port_cls()) == _as_plain(jax_cls())


@pytest.mark.parametrize("preset", ["config", "config_san",
                                    "config_transformer_co", "config_vit"])
def test_from_cfg_equals_jax(preset):
    train = config_mod.compose(preset)["train"]
    expected = jax_configs.ModelConfig.from_cfg(train, 1234, use_pallas=False)
    got = port_configs.ModelConfig.from_cfg(train, 1234, use_pallas=False)
    assert _as_plain(got) == _as_plain(expected)
    assert got.image.output_grid(got.image_size) == \
        expected.image.output_grid(expected.image_size)


def test_from_meta_dict_reads_the_jax_metadata():
    jax_cfg = jax_configs.ModelConfig(num_tokens=77, max_answers=9)
    meta = dataclasses.asdict(jax_cfg)
    meta["image"]["future_field"] = 1  # forward-compatible key filtering
    got = port_configs.ModelConfig.from_meta_dict(meta)
    assert _as_plain(got) == _as_plain(jax_cfg)
    assert isinstance(got.image.num_channels, tuple)


def test_reference_config_is_ported_and_variants_are_not():
    port_configs.ModelConfig().check_ported()
    vit = port_configs.ModelConfig.from_cfg(
        config_mod.compose("config_vit")["train"], 10)
    with pytest.raises(NotImplementedError, match="image.encoder"):
        vit.check_ported()
