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
    """Every preset is ported: the reference, the ViT, the ViT-MoE and the
    two variant presets (stacked attention; the transformer text encoder
    with co-attention). MoE blocks with the CNN encoder and ``num_lstm_layers
    != 1`` raise the JAX package's own refusals."""
    port_configs.ModelConfig().check_ported()
    vit = port_configs.ModelConfig.from_cfg(
        config_mod.compose("config_vit")["train"], 10)
    assert vit.image.encoder == "vit" and vit.image.moe_experts == 0
    vit.check_ported()
    for preset, text, variant in (("config_san", "lstm", "stacked"),
                                  ("config_transformer_co", "transformer",
                                   "co")):
        cfg = port_configs.ModelConfig.from_cfg(
            config_mod.compose(preset)["train"], 10)
        assert (cfg.text.encoder, cfg.attention.variant) == (text, variant)
        cfg.check_ported()
    moe = port_configs.ModelConfig.from_cfg(
        config_mod.compose("config_vit_moe")["train"], 10)
    assert (moe.image.moe_experts, moe.image.moe_top_k) == (8, 2)
    moe.check_ported()
    cnn_moe = dataclasses.replace(moe, image=dataclasses.replace(
        moe.image, encoder="cnn"))
    with pytest.raises(ValueError, match="requires image.encoder='vit'"):
        cnn_moe.check_ported()  # the JAX model's refusal, in its words
    base = port_configs.ModelConfig()
    two = dataclasses.replace(base, text=dataclasses.replace(
        base.text, num_lstm_layers=2))
    with pytest.raises(NotImplementedError,
                       match="num_lstm_layers=2; only 1 is supported"):
        two.check_ported()
    dataclasses.replace(two, text=dataclasses.replace(
        two.text, encoder="transformer")).check_ported()  # no LSTM there


@pytest.mark.parametrize("fields,error,match", [
    ({"moe_experts": 8}, None, None),
    ({"store_dtype": "f8e4m3"}, ValueError, "CNN-stem serving mode"),
], ids=["moe", "f8"])
def test_vit_options_that_are_not_ported_raise(fields, error, match):
    """f8 storage with the ViT is refused by the JAX model too (a
    ``ValueError``). MoE blocks are ported: that case passes the check, and
    a model with them is built (``error`` None)."""
    base = port_configs.ModelConfig()
    cfg = dataclasses.replace(base, image=dataclasses.replace(
        base.image, encoder="vit", **fields))
    if error is None:
        cfg.check_ported()
        small = dataclasses.replace(cfg, image=dataclasses.replace(
            cfg.image, num_channels=(3, 64), num_layers=1, num_heads=1),
            text=dataclasses.replace(cfg.text, question_features=8,
                                     embedding_features=4),
            num_tokens=10)
        from dl_vqa_tpu_torch.models.vqa import VqaNet

        model = VqaNet(small, device="cpu")
        assert model.image.blocks[0].moe.gate.shape == (8, 64)
        return
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


@pytest.mark.parametrize("preset", ["config_san", "config_transformer_co",
                                    "config_vit_moe"])
def test_chip_smoke_builds_the_variant_presets_as_the_yaml_gives_them(preset):
    """``chip_smoke.py``'s phase 14 builds each variant preset from the
    port's preset dicts (no PyYAML): the JAX package's configuration of
    the preset's YAML, at the reference's vocabulary."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    expected = jax_configs.ModelConfig.from_cfg(
        config_mod.compose(preset)["train"],
        port_configs.ModelConfig().num_tokens)
    assert _as_plain(chip_smoke.variant_config(preset)) == _as_plain(expected)
