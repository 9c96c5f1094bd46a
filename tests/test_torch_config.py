"""The port's ModelConfig against the JAX package's, field by field."""

import dataclasses
import importlib.util
import os

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
    assert vit.image.encoder == "vit" and vit.image.moe_experts == 0
    vit.check_ported()
    moe = port_configs.ModelConfig.from_cfg(
        config_mod.compose("config_vit_moe")["train"], 10)
    with pytest.raises(NotImplementedError, match="image.moe_experts"):
        moe.check_ported()


@pytest.mark.parametrize("fields,error,match", [
    ({"moe_experts": 8}, NotImplementedError, "moe_experts=8"),
    ({"store_dtype": "int8"}, NotImplementedError, "store_dtype='int8'"),
    ({"store_dtype": "f8e4m3"}, ValueError, "CNN-stem serving mode"),
], ids=["moe", "int8", "f8"])
def test_vit_options_that_are_not_ported_raise(fields, error, match):
    """MoE blocks and the int8 projections are still to port; f8 storage
    with the ViT is refused by the JAX model too (a ``ValueError``)."""
    base = port_configs.ModelConfig()
    cfg = dataclasses.replace(base, image=dataclasses.replace(
        base.image, encoder="vit", **fields))
    with pytest.raises(error, match=match):
        cfg.check_ported()


def test_chip_smoke_builds_the_model_of_config_vit():
    """``chip_smoke.py`` runs where PyYAML is not assured, so it builds
    the ViT configuration in code: the same as the preset gives."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    expected = port_configs.ModelConfig.from_cfg(
        config_mod.compose("config_vit")["train"],
        port_configs.ModelConfig().num_tokens)
    assert _as_plain(chip_smoke.vit_config()) == _as_plain(expected)
    assert chip_smoke.VIT_TOKENS == expected.image.output_grid(224) ** 2
