"""Static model configuration for the PyTorch port.

Field for field the same frozen dataclasses as
:mod:`dl_vqa_tpu.models.configs`, with the same defaults, so a
``dataclasses.asdict`` written by either package reads back in the other.
The port keeps its own copy because importing the JAX one goes through
``dl_vqa_tpu.models``, whose ``__init__`` imports JAX.

:meth:`ModelConfig.check_ported` names the variants this package cannot
run yet and makes the JAX model's own refusals;
:class:`dl_vqa_tpu_torch.models.vqa.VqaNet` calls it when it is built and
at every forward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["TextConfig", "ImageConfig", "AttentionConfig", "ClassifierConfig",
           "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class TextConfig:
    encoder: str = "lstm"              # 'lstm' | 'transformer'
    question_features: int = 1024
    embedding_features: int = 300
    dropout: float = 0.3
    num_lstm_layers: int = 1
    bidirectional: bool = True
    num_heads: int = 8                 # transformer only
    num_layers: int = 2                # transformer only
    max_positions: int = 64            # transformer only

    @property
    def output_features(self) -> int:
        if self.encoder == "transformer":
            return self.question_features
        return self.question_features * (2 if self.bidirectional else 1)


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    encoder: str = "cnn"               # 'cnn' | 'vit'
    kernel_size: int = 3
    dropout: float = 0.3
    num_channels: Tuple[int, ...] = (3, 64, 128, 256)
    stride: int = 1
    patch_size: int = 16               # vit only
    num_layers: int = 4                # vit only
    num_heads: int = 4                 # vit only
    store_dtype: str = "compute"       # 'compute' | 'f8e4m3' | 'int8'
    quant_scales: Tuple[float, ...] = ()
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def output_channels(self) -> int:
        return self.num_channels[-1]

    def output_grid(self, image_size: int) -> int:
        """Side of the feature grid: VALID convs and floor 2x2 pools for
        'cnn', the patch grid for 'vit'."""
        if self.encoder == "vit":
            return image_size // self.patch_size
        size = image_size
        for _ in range(len(self.num_channels) - 1):
            size = (size - self.kernel_size) // self.stride + 1
            size = size // 2
        return size


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    variant: str = "single"            # 'single' | 'stacked' | 'co'
    hidden_dim: int = 1024
    glimpses: int = 2
    do_option: str = "+"               # '*' | '+' | '|'
    dropout: float = 0.3


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    hidden_dim: int = 1024
    dropout: float = 0.3


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    text: TextConfig = TextConfig()
    image: ImageConfig = ImageConfig()
    attention: AttentionConfig = AttentionConfig()
    classifier: ClassifierConfig = ClassifierConfig()
    max_answers: int = 3000
    image_size: int = 224
    num_tokens: int = 15193            # question vocab size + 1
    use_pallas: bool = True            # read by the JAX package only

    def check_ported(self, train: Optional[bool] = None) -> None:
        """Raise ``NotImplementedError`` for a variant the port lacks (an
        unknown image encoder), and the JAX package's own error, in its
        words, for what it refuses too (``NotImplementedError`` for
        ``num_lstm_layers != 1`` or an unknown text encoder or attention
        variant, ``ValueError`` for a combination: MoE blocks with the CNN
        encoder or with the int8 mode, for instance). With ``train`` given
        (a forward's), also the refusals the JAX model makes when it runs:
        the int8 mode in training, and int8 without its calibrated scales
        or with the wrong number."""
        unported = []
        if self.text.encoder not in ("lstm", "transformer"):
            raise NotImplementedError(f"text encoder {self.text.encoder!r}")
        if self.text.encoder == "lstm" and self.text.num_lstm_layers != 1:
            # The JAX model's own refusal (and the reference's: a single
            # layer only), not a gap of the port.
            raise NotImplementedError(
                f"num_lstm_layers={self.text.num_lstm_layers}; only 1 is "
                "supported")
        if self.image.encoder not in ("cnn", "vit"):
            unported.append(f"image.encoder={self.image.encoder!r}")
        store = self.image.store_dtype
        if self.image.encoder == "vit" and store not in ("compute", "int8"):
            raise ValueError(
                f"image.store_dtype={store!r} is a CNN-stem "
                "serving mode (quantized conv-output storage); the vit "
                "encoder supports 'compute' or 'int8' (W8A8 block matmuls)")
        if store not in ("compute", "f8e4m3", "int8"):
            raise ValueError(
                f"image.store_dtype={store!r}; expected "
                "'compute', 'f8e4m3' or 'int8'")
        if store == "int8" and self.image.encoder == "vit" \
                and self.image.moe_experts > 0:
            raise ValueError(
                "image.store_dtype='int8' does not support MoE "
                "blocks (no W8A8 path for the expert einsums)")
        if self.image.encoder == "cnn" and self.image.moe_experts > 0:
            # dl_vqa_tpu/models/vqa.py::init's refusal.
            raise ValueError(
                f"image.moe_experts={self.image.moe_experts} requires "
                "image.encoder='vit' (the cnn stack has no MLP blocks "
                "to sparsify)")
        if self.attention.variant not in ("single", "stacked", "co"):
            raise NotImplementedError(
                f"attention variant {self.attention.variant!r}")
        if self.attention.do_option not in ("*", "+", "|"):
            raise ValueError(
                f"Unknown do_option {self.attention.do_option!r}")
        if unported:
            raise NotImplementedError(
                "not ported to dl_vqa_tpu_torch yet: " + ", ".join(unported))
        if train is None or store != "int8":
            return
        calibrate = ("ops.vit_int8.calibrate_vit_scales"
                     if self.image.encoder == "vit"
                     else "ops.conv_int8.calibrate_stem_scales")
        if train:
            raise ValueError(
                "image.store_dtype='int8' is inference-only: its static "
                "activation scales are calibrated FROM trained weights "
                f"({calibrate}). Train with store_dtype='compute' and "
                "switch at serving time.")
        scales = self.image.quant_scales
        if self.image.encoder == "vit":
            expected = 4 * self.image.num_layers
            if len(scales) != expected:
                raise ValueError(
                    f"image.quant_scales has {len(scales)} entries; the vit "
                    f"W8A8 mode needs {expected} (4 per block) — calibrate "
                    "with ops.vit_int8.with_calibrated_vit_scales")
        elif not scales:
            raise ValueError(
                "image.store_dtype='int8' needs calibrated activation "
                "scales: run ops.conv_int8.calibrate_stem_scales on sample "
                "batches and set them via dataclasses.replace(cfg.image, "
                "quant_scales=...)")

    def with_checkpoint_scales(self, meta: dict) -> "ModelConfig":
        """In the int8 mode with no scales, the scales a calibrate-once
        checkpoint carries in its metadata (``meta["model_cfg"]``), where
        it has them; else this configuration as it is."""
        scales = (meta.get("model_cfg") or {}).get("image", {}).get(
            "quant_scales")
        if (self.image.store_dtype != "int8" or self.image.quant_scales
                or not scales):
            return self
        return dataclasses.replace(self, image=dataclasses.replace(
            self.image, quant_scales=tuple(float(v) for v in scales)))

    @classmethod
    def from_meta_dict(cls, d: dict) -> "ModelConfig":
        """Rebuild from ``dataclasses.asdict(model_cfg)`` as stored in
        checkpoint metadata; unknown keys are dropped, JSON lists become
        tuples."""
        def pick(dc_cls, sub: dict) -> dict:
            fields = {f.name for f in dataclasses.fields(dc_cls)}
            return {k: v for k, v in sub.items() if k in fields}

        image = pick(ImageConfig, d["image"])
        if "num_channels" in image:
            image["num_channels"] = tuple(image["num_channels"])
        if "quant_scales" in image:
            image["quant_scales"] = tuple(image["quant_scales"])
        top = pick(cls, d)
        top.update(
            text=TextConfig(**pick(TextConfig, d["text"])),
            image=ImageConfig(**image),
            attention=AttentionConfig(**pick(AttentionConfig,
                                             d["attention"])),
            classifier=ClassifierConfig(**pick(ClassifierConfig,
                                               d["classifier"])),
        )
        return cls(**top)

    @classmethod
    def from_cfg(cls, train_cfg: dict, num_tokens: int,
                 use_pallas: bool = True) -> "ModelConfig":
        """Build from the ``train`` config group and the token count."""
        t, i = train_cfg["text"], train_cfg["image"]
        a, c = train_cfg["attention"], train_cfg["classifier"]
        return cls(
            text=TextConfig(
                encoder=t.get("encoder", "lstm"),
                question_features=t["question_features"],
                embedding_features=t["embedding_features"],
                dropout=t["dropout"],
                num_lstm_layers=t["num_lstm_layers"],
                bidirectional=t["bidirectional"],
                num_heads=t.get("num_heads", 8),
                num_layers=t.get("num_layers", 2),
                max_positions=t.get("max_positions", 64),
            ),
            image=ImageConfig(
                encoder=i.get("encoder", "cnn"),
                kernel_size=i["kernel_size"],
                dropout=i["dropout"],
                num_channels=tuple(i["num_channels"]),
                stride=i["stride"],
                patch_size=i.get("patch_size", 16),
                num_layers=i.get("num_layers", 4),
                num_heads=i.get("num_heads", 4),
                store_dtype=i.get("store_dtype", "compute"),
                moe_experts=i.get("moe_experts", 0),
                moe_top_k=i.get("moe_top_k", 2),
                moe_capacity_factor=i.get("moe_capacity_factor", 1.25),
                moe_aux_weight=i.get("moe_aux_weight", 0.01),
            ),
            attention=AttentionConfig(
                variant=a.get("variant", "single"),
                hidden_dim=a["hidden_dim"],
                glimpses=a["glimpses"],
                do_option=a["do_option"],
                dropout=a["dropout"],
            ),
            classifier=ClassifierConfig(
                hidden_dim=c["hidden_dim"],
                dropout=c["dropout"],
            ),
            max_answers=train_cfg["max_answers"],
            image_size=train_cfg["image_size"],
            num_tokens=num_tokens,
            use_pallas=use_pallas,
        )
