"""Configuration system for the VCoder-TPU framework.

One frozen-dataclass config tree covers all four model variants of the
reference (reference: SURVEY.md §2.2; vcoder_llava/model/language_model/*.py)
via feature flags instead of a class-inheritance pyramid:

    model_type          extra branches enabled
    ----------------    -----------------------------------------------
    llava               (none)
    vcoder_llava        use_seg, use_mm2_proj, use_vcoder_lm_emb
    vcoder_ds_llava     + use_depth
    vcoder_it_llava     use_seg only (regular embed_tokens)

Configs serialize to/from JSON and can be reconstructed from a HuggingFace
``config.json`` of the published checkpoints (shi-labs/vcoder_*_llava-v1.5,
liuhaotian/llava-v1.5-*), honoring the persisted fields the reference writes
in its ``initialize_*_modules`` (reference: vcoder_llava/model/
vcoder_llava_arch.py:95-113).

A copy of ``vcoder_tpu/config.py`` for the PyTorch port, which imports nothing
of ``vcoder_tpu``; keep the two in step.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT vision tower config (default: ViT-L/14 @ 336px).

    reference: vcoder_llava/model/multimodal_encoder/clip_encoder.py
    """

    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    # Hidden-state layer used as image features; -2 == penultimate layer
    # (reference: scripts/v1_5/vcoder_train.sh --mm_vision_select_layer -2).
    select_layer: int = -2
    # 'patch' drops the CLS token; 'cls_patch' keeps it.
    # (reference: clip_encoder.py:29-37)
    select_feature: str = "patch"

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side**2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Llama (Vicuna v1.5) decoder config."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


_MLP_GELU_RE = re.compile(r"^mlp(\d+)x_gelu$")


def projector_depth(projector_type: str) -> int:
    """Number of Linear layers in a projector spec.

    ``linear`` -> 1; ``mlpNx_gelu`` -> N; ``identity`` -> 0.
    (reference: vcoder_llava/model/multimodal_projector/builder.py:33-51)
    """
    if projector_type == "linear":
        return 1
    if projector_type == "identity":
        return 0
    m = _MLP_GELU_RE.match(projector_type)
    if m:
        return int(m.group(1))
    raise ValueError(f"Unknown projector type: {projector_type}")


@dataclasses.dataclass(frozen=True)
class VCoderConfig:
    """Top-level model config covering all four reference variants."""

    model_type: str = "llava"  # llava | vcoder_llava | vcoder_ds_llava | vcoder_it_llava
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)

    mm_projector_type: str = "mlp2x_gelu"
    seg_mm_projector_type: str = "mlp2x_gelu"
    depth_mm_projector_type: str = "mlp2x_gelu"

    # Branch flags (derived from model_type by `standard()`, but kept explicit
    # so checkpoints with unusual configs round-trip).
    use_seg: bool = False
    use_depth: bool = False
    # Second image projector used in place of mm_projector when segs present
    # (reference: vcoder_llava_arch.py:40-42,141-144).
    use_mm2_proj: bool = False
    # Trainable clone of the LM embedding table used for text when segs
    # present (reference: vcoder_llava_arch.py:180).
    use_vcoder_lm_emb: bool = False
    # Checkpoint-fidelity quirk: the reference projects depth features through
    # the *seg* projector (reference: vcoder_ds_llava_arch.py:111-114). The
    # separately-trained depth_mm_projector is dead at that call site. Keep ON
    # for parity with published weights.
    depth_through_seg_projector: bool = True

    image_aspect_ratio: str = "pad"
    model_max_length: int = 2048

    def __post_init__(self):
        if self.model_type not in (
            "llava",
            "vcoder_llava",
            "vcoder_ds_llava",
            "vcoder_it_llava",
        ):
            raise ValueError(f"Unknown model_type: {self.model_type}")

    # ---- constructors ----

    @staticmethod
    def standard(
        model_type: str = "llava",
        size: str = "7b",
        **overrides: Any,
    ) -> "VCoderConfig":
        """Production config for a given variant and decoder size."""
        if size == "7b":
            text = TextConfig()
        elif size == "13b":
            text = TextConfig(
                hidden_size=5120,
                intermediate_size=13824,
                num_layers=40,
                num_heads=40,
                num_kv_heads=40,
            )
        else:
            raise ValueError(f"Unknown size: {size}")
        flags = _variant_flags(model_type)
        return VCoderConfig(
            model_type=model_type, text=text, **{**flags, **overrides}
        )

    @staticmethod
    def tiny(model_type: str = "llava", **overrides: Any) -> "VCoderConfig":
        """Small config for unit tests (runs on CPU in milliseconds)."""
        vision = VisionConfig(
            image_size=28,
            patch_size=14,
            hidden_size=16,
            intermediate_size=32,
            num_layers=2,
            num_heads=2,
        )
        text = TextConfig(
            vocab_size=256,
            hidden_size=32,
            intermediate_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            max_position_embeddings=512,
        )
        flags = _variant_flags(model_type)
        return VCoderConfig(
            model_type=model_type,
            vision=vision,
            text=text,
            **{**flags, **overrides},
        )

    # ---- serialization ----

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "VCoderConfig":
        d = dict(d)
        d["vision"] = VisionConfig(**d.get("vision", {}))
        d["text"] = TextConfig(**d.get("text", {}))
        return VCoderConfig(**d)

    @staticmethod
    def from_json(s: str) -> "VCoderConfig":
        return VCoderConfig.from_dict(json.loads(s))

    def to_hf_config(self) -> dict:
        """Emit a HuggingFace-style ``config.json`` dict (the inverse of
        :meth:`from_hf_config`; field names follow what the reference
        persists in its ``initialize_*_modules``)."""
        hf = {
            "model_type": self.model_type,
            "architectures": [
                {
                    "llava": "LlavaLlamaForCausalLM",
                    "vcoder_llava": "VCoderLlavaLlamaForCausalLM",
                    "vcoder_ds_llava": "VCoderDSLlavaLlamaForCausalLM",
                    "vcoder_it_llava": "VCoderITLlavaLlamaForCausalLM",
                }[self.model_type]
            ],
            "vocab_size": self.text.vocab_size,
            "hidden_size": self.text.hidden_size,
            "intermediate_size": self.text.intermediate_size,
            "num_hidden_layers": self.text.num_layers,
            "num_attention_heads": self.text.num_heads,
            "num_key_value_heads": self.text.num_kv_heads,
            "rope_theta": self.text.rope_theta,
            "rms_norm_eps": self.text.rms_norm_eps,
            "max_position_embeddings": self.text.max_position_embeddings,
            "bos_token_id": self.text.bos_token_id,
            "eos_token_id": self.text.eos_token_id,
            "pad_token_id": self.text.pad_token_id,
            "mm_vision_tower": "openai/clip-vit-large-patch14-336",
            "mm_vision_select_layer": self.vision.select_layer,
            "mm_vision_select_feature": self.vision.select_feature,
            "mm_hidden_size": self.vision.hidden_size,
            "mm_projector_type": self.mm_projector_type,
            "image_aspect_ratio": self.image_aspect_ratio,
            "model_max_length": self.model_max_length,
            # Non-standard (ours): full vision geometry so tiny test
            # checkpoints round-trip exactly.
            "vcoder_tpu_vision": dataclasses.asdict(self.vision),
        }
        if self.use_seg:
            hf["seg_mm_projector_type"] = self.seg_mm_projector_type
            hf["seg_mm_hidden_size"] = self.vision.hidden_size
        if self.use_depth:
            hf["depth_mm_projector_type"] = self.depth_mm_projector_type
            hf["depth_mm_hidden_size"] = self.vision.hidden_size
        if self.use_mm2_proj:
            hf["use_mm2_proj"] = True
        if self.use_vcoder_lm_emb:
            hf["mm_vcoder_lm_emb"] = True
        return hf

    @staticmethod
    def from_hf_config(hf: dict) -> "VCoderConfig":
        """Build from a HuggingFace ``config.json`` dict of the published
        llava / vcoder_llava / vcoder_ds_llava / vcoder_it_llava checkpoints.
        """
        model_type = hf.get("model_type", "llava")
        text = TextConfig(
            vocab_size=hf.get("vocab_size", 32000),
            hidden_size=hf.get("hidden_size", 4096),
            intermediate_size=hf.get("intermediate_size", 11008),
            num_layers=hf.get("num_hidden_layers", 32),
            num_heads=hf.get("num_attention_heads", 32),
            num_kv_heads=hf.get(
                "num_key_value_heads", hf.get("num_attention_heads", 32)
            ),
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            bos_token_id=hf.get("bos_token_id", 1),
            eos_token_id=hf.get("eos_token_id", 2),
            pad_token_id=hf.get("pad_token_id", 0) or 0,
        )
        if "vcoder_tpu_vision" in hf:
            vision = VisionConfig(**hf["vcoder_tpu_vision"])
        else:
            vision = VisionConfig(
                select_layer=hf.get("mm_vision_select_layer", -2),
                select_feature=hf.get("mm_vision_select_feature", "patch"),
            )
        flags = _variant_flags(model_type)
        # Explicit config fields override variant defaults.
        if "use_mm2_proj" in hf:
            flags["use_mm2_proj"] = bool(hf["use_mm2_proj"])
        if "mm_vcoder_lm_emb" in hf:
            flags["use_vcoder_lm_emb"] = bool(hf["mm_vcoder_lm_emb"])
        return VCoderConfig(
            model_type=model_type,
            vision=vision,
            text=text,
            mm_projector_type=hf.get("mm_projector_type", "mlp2x_gelu"),
            seg_mm_projector_type=hf.get("seg_mm_projector_type", "mlp2x_gelu"),
            depth_mm_projector_type=hf.get(
                "depth_mm_projector_type", "mlp2x_gelu"
            ),
            image_aspect_ratio=hf.get("image_aspect_ratio", "pad"),
            model_max_length=hf.get(
                "max_sequence_length", hf.get("model_max_length", 2048)
            ),
            **flags,
        )


def _variant_flags(model_type: str) -> dict:
    if model_type == "llava":
        return dict(
            use_seg=False, use_depth=False, use_mm2_proj=False, use_vcoder_lm_emb=False
        )
    if model_type == "vcoder_llava":
        return dict(
            use_seg=True, use_depth=False, use_mm2_proj=True, use_vcoder_lm_emb=True
        )
    if model_type == "vcoder_ds_llava":
        return dict(
            use_seg=True, use_depth=True, use_mm2_proj=True, use_vcoder_lm_emb=True
        )
    if model_type == "vcoder_it_llava":
        return dict(
            use_seg=True, use_depth=False, use_mm2_proj=False, use_vcoder_lm_emb=False
        )
    raise ValueError(f"Unknown model_type: {model_type}")
