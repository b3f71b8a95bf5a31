"""Model loading: ``load_pretrained_model`` (port of ``vcoder_tpu/builder.py``).

Returns the reference's 6-tuple (reference: vcoder_llava/model/builder.py)

    (tokenizer, model, image_processor,
     seg_image_processor, depth_image_processor, context_len)

with the same name-based gating of the seg/depth processors and the same
``context_len``. The model lives on ``device`` (CUDA by default; raises when
CUDA is absent unless ``device="cpu"``). ``load_8bit`` / ``load_4bit``
quantize the large matmul weights on the device after loading
(``quant.quantize_params``, as ``vcoder_tpu/builder.py:203-206``).
Checkpoints over a ``model_base`` (adapter, LoRA) wait for a later slice and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from vcoder_tpu_torch import generation as gen_mod
from vcoder_tpu_torch.checkpoint import load_hf_checkpoint
from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.device import resolve_device
from vcoder_tpu_torch.mm_tokens import get_model_name_from_path
from vcoder_tpu_torch.preprocess import CLIP_IMAGE_MEAN, process_images
from vcoder_tpu_torch.quant import quantize_params


class VCoderImageProcessor:
    """CLIPImageProcessor-protocol shim over :func:`process_images`."""

    image_mean = CLIP_IMAGE_MEAN

    def __init__(self, size: int = 336, image_aspect_ratio: str = "pad", device="cuda"):
        self.size = size
        self.image_aspect_ratio = image_aspect_ratio
        self.crop_size = {"height": size, "width": size}
        self.device = device

    def preprocess(self, images, **kw):
        """{"pixel_values": [B, size, size, 3] f32 tensor on the device}."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        arr = process_images(
            images,
            image_aspect_ratio=kw.get("image_aspect_ratio", self.image_aspect_ratio),
            size=self.size,
            device=self.device,
        )
        return {"pixel_values": arr}

    def __call__(self, images, **kw):
        return self.preprocess(images, **kw)


class VCoderForCausalLM:
    """(config, params) with HF-generate-like semantics:
    ``generate(input_ids, images=, segs=, depths=, ...)``."""

    def __init__(self, cfg: VCoderConfig, params: dict):
        self.config = cfg
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.params["lm"]["embed_tokens"].device

    def generate(
        self,
        input_ids: Sequence[Sequence[int]],
        images=None,
        segs=None,
        depths=None,
        *,
        max_new_tokens: int = 512,
        temperature: float = 0.0,
        top_p: float = 1.0,
        do_sample: Optional[bool] = None,
        tokenizer=None,
        stopping_criteria=None,
        seed: int = 0,
        **kw,
    ) -> gen_mod.GenerationResult:
        if do_sample is False:
            temperature = 0.0
        elif do_sample and temperature <= 0.0:
            temperature = 1.0  # HF: do_sample with no temperature samples at 1.0
        return gen_mod.generate(
            self.params,
            self.config,
            input_ids,
            images,
            segs,
            depths,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_p=top_p,
            seed=seed,
            tokenizer=tokenizer,
            stopping_criteria=stopping_criteria,
            # Unknown HF-generate kwargs (use_cache, top_k, ...) are accepted
            # and ignored, like the HF API.
            **{
                k: v
                for k, v in kw.items()
                if k in ("pad_to", "attn_impl", "is_depth_zero", "is_seg_zero")
            },
        )


def _load_tokenizer(model_path: str):
    from vcoder_tpu_torch import simple_tokenizer

    if os.path.exists(os.path.join(model_path, simple_tokenizer.FILENAME)):
        return simple_tokenizer.SimpleTokenizer.from_pretrained(model_path)
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None
    try:
        return AutoTokenizer.from_pretrained(model_path, use_fast=False)
    except Exception:
        try:
            return AutoTokenizer.from_pretrained(model_path)
        except Exception:
            return None


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    model_name: Optional[str] = None,
    load_8bit: bool = False,
    load_4bit: bool = False,
    device_map: str = "auto",
    device="cuda",
    *,
    dtype=torch.bfloat16,
    tokenizer=None,
):
    """Load a local HF-format VCoder/LLaVA checkpoint directory onto
    ``device``."""
    dev = resolve_device(device)
    if model_name is None:
        model_name = get_model_name_from_path(model_path)
    if model_base is not None:
        raise NotImplementedError("adapter and LoRA checkpoints over a base are not ported yet")
    cfg, params = load_hf_checkpoint(model_path, dtype=dtype, device=dev)
    if load_8bit or load_4bit:
        params = quantize_params(params, bits=8 if load_8bit else 4)

    if tokenizer is None:
        tokenizer = _load_tokenizer(model_path)
    model = VCoderForCausalLM(cfg, params)
    image_processor = VCoderImageProcessor(
        size=cfg.vision.image_size, image_aspect_ratio=cfg.image_aspect_ratio, device=dev
    )
    lname = model_name.lower()
    seg_image_processor = image_processor if "vcoder" in lname else None
    depth_image_processor = image_processor if "ds" in lname else None
    context_len = cfg.model_max_length or 2048
    return (
        tokenizer,
        model,
        image_processor,
        seg_image_processor,
        depth_image_processor,
        context_len,
    )
