"""In-process chat worker: base64 images in, JSON text chunks out (port of
``vcoder_tpu/serve/chat.py``).

:class:`Chat` keeps the reference protocol: sentinel-count ``ValueError``s
against the prompt, the token-budget clamp counting 576 vision tokens per
modality, a full context streamed as a normal message, seg/depth support
inferred from the model name (so a checkpoint directory must be named like
``vcoder_ds_llava-...``), NUL-framed JSON chunks, and the error-swallowing
``generate_stream_gate``. Greedy requests stream through prompt-lookup
speculative decoding with ``lookahead`` 8 unless the request says otherwise.

Images are decoded by :func:`load_image_from_base64`: PNG through the port's
own decoder (``png.decode_png``) on every machine, other formats through PIL
(a ``ValueError`` where PIL is missing). Preprocessing runs on the model's
device, in whichever thread calls :meth:`Chat.prepare`.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
from typing import Iterator, List, Optional

import numpy as np

from vcoder_tpu_torch import generation as gen_mod
from vcoder_tpu_torch.builder import load_pretrained_model
from vcoder_tpu_torch.constants import DEFAULT_DEPTH_TOKEN, DEFAULT_IMAGE_TOKEN, DEFAULT_SEG_TOKEN
from vcoder_tpu_torch.device import resolve_device
from vcoder_tpu_torch.mm_tokens import (
    get_model_name_from_path,
    tokenizer_depth_seg_token,
    tokenizer_image_token,
    tokenizer_seg_token,
)
from vcoder_tpu_torch.png import load_image_bytes
from vcoder_tpu_torch.utils import server_error_msg

logger = logging.getLogger("chat")

# The stream's lookahead when the request names none (or None).
DEFAULT_LOOKAHEAD = 8


def load_image_from_base64(image: str) -> np.ndarray:
    """A base64 image -> ``[H, W, 3] uint8`` RGB (``png.load_image_bytes``)."""
    return load_image_bytes(base64.b64decode(image))


@dataclasses.dataclass
class PreparedRequest:
    """A wire-protocol params dict resolved into model inputs: sentinel ids
    spliced, pixels preprocessed, and the token budget clamped."""

    ori_prompt: str
    input_ids: List[int]
    images: Optional[object]  # [1, N?, H, W, C] arrays or None
    segs: Optional[object]
    depths: Optional[object]
    max_new_tokens: int
    temperature: float
    top_p: float
    stop_str: Optional[str]
    budget_error: Optional[str] = None  # set when the context is full
    lora: Optional[str] = None  # adapter name (multi-LoRA engines)


def json_chunk(text: str, error_code: int) -> bytes:
    """One chunk of the worker API: NUL-terminated JSON."""
    return json.dumps({"text": text, "error_code": error_code}).encode() + b"\0"


class Chat:
    def __init__(
        self,
        model_path: str,
        model_base=None,
        model_name=None,
        load_8bit: bool = False,
        load_4bit: bool = False,
        device="cuda",
        tokenizer=None,
    ):
        self.device = resolve_device(device)
        if model_name is None:
            model_name = get_model_name_from_path(model_path)
        self.model_name = model_name
        (
            self.tokenizer,
            self.model,
            self.image_processor,
            self.seg_image_processor,
            self.depth_image_processor,
            self.context_len,
        ) = load_pretrained_model(
            model_path, model_base, model_name, load_8bit, load_4bit, device=self.device,
            tokenizer=tokenizer,
        )
        lname = self.model_name.lower()
        self.is_multimodal = "llava" in lname
        # Seg/depth support inferred from the name, as the reference does.
        self.is_seg = "vcoder" in lname
        self.is_depth = "ds" in lname

    @property
    def num_patches(self) -> int:
        return self.model.config.vision.num_patches

    def _pixels(self, processor, items, prompt: str, sentinel: str, what: str):
        """Decode + preprocess one modality's base64 images; their count must
        equal the sentinel's count in the prompt. Returns (pixels, vision
        tokens): [N, H, W, C] for one image, [1, N, H, W, C] for N > 1 (one
        conversation row, N sentinel occurrences)."""
        if len(items) != prompt.count(sentinel):
            raise ValueError(
                f"Number of {what} does not match number of {sentinel} tokens in prompt"
            )
        px = processor.preprocess([load_image_from_base64(x) for x in items])["pixel_values"]
        if len(items) > 1:
            px = px[None]
        return px, prompt.count(sentinel) * self.num_patches

    def prepare(self, params: dict) -> PreparedRequest:
        """Validate + preprocess one request (``chat.py:95``). Raises
        ValueError on sentinel/image mismatches; a full context comes back as
        ``budget_error``."""
        prompt = params["prompt"]
        images = params.get("images", None)
        segs = params.get("segs", None)
        depths = params.get("depths", None)
        n_img = n_seg = n_dep = 0
        px_images = px_segs = px_depths = None
        if images is not None and len(images) > 0 and self.is_multimodal:
            px_images, n_img = self._pixels(self.image_processor, images, prompt,
                                            DEFAULT_IMAGE_TOKEN, "images")
            if segs is not None and len(segs) > 0 and self.is_seg:
                px_segs, n_seg = self._pixels(self.seg_image_processor, segs, prompt,
                                              DEFAULT_SEG_TOKEN, "segs")
                if depths is not None and len(depths) > 0 and self.is_depth:
                    px_depths, n_dep = self._pixels(self.depth_image_processor, depths, prompt,
                                                    DEFAULT_DEPTH_TOKEN, "depths")

        temperature = float(params.get("temperature", 1.0))
        top_p = float(params.get("top_p", 1.0))
        max_context_length = self.model.config.text.max_position_embeddings
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop", None)

        if self.is_seg and px_segs is not None:
            if self.is_depth and px_depths is not None:
                input_ids = tokenizer_depth_seg_token(prompt, self.tokenizer)
            else:
                input_ids = tokenizer_seg_token(prompt, self.tokenizer)
        else:
            input_ids = tokenizer_image_token(prompt, self.tokenizer)
            px_segs = px_depths = None

        max_new_tokens = min(
            max_new_tokens, max_context_length - len(input_ids) - n_img - n_seg - n_dep
        )
        budget_error = None
        if max_new_tokens < 1:
            budget_error = "Exceeds max token length. Please start a new conversation, thanks."
        return PreparedRequest(
            ori_prompt=prompt,
            input_ids=list(input_ids),
            images=px_images,
            segs=px_segs,
            depths=px_depths,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_p=top_p,
            stop_str=stop_str,
            budget_error=budget_error,
            lora=params.get("lora"),
        )

    def generate_stream(self, params: dict) -> Iterator[bytes]:
        prep = self.prepare(params)
        ori_prompt, stop_str = prep.ori_prompt, prep.stop_str
        if prep.budget_error is not None:
            yield json_chunk(ori_prompt + prep.budget_error, 0)
            return
        # An explicit 0/1 disables speculation; only a missing or None key
        # means the default.
        lookahead = params.get("lookahead", DEFAULT_LOOKAHEAD)
        lookahead = DEFAULT_LOOKAHEAD if lookahead is None else int(lookahead)
        for text in gen_mod.generate_stream(
            self.model.params,
            self.model.config,
            [prep.input_ids],
            prep.images,
            prep.segs,
            prep.depths,
            tokenizer=self.tokenizer,
            max_new_tokens=prep.max_new_tokens,
            temperature=prep.temperature,
            top_p=prep.top_p,
            stop_str=stop_str,
            lookahead=lookahead,
        ):
            generated_text = ori_prompt + text
            if stop_str and generated_text.endswith(stop_str):
                generated_text = generated_text[: -len(stop_str)]
            yield json_chunk(generated_text, 0)

    def generate_stream_gate(self, params: dict) -> Iterator[bytes]:
        yield from stream_gate(self.generate_stream(params))


def stream_gate(chunks: Iterator[bytes]) -> Iterator[bytes]:
    """``chunks``, with a failure turned into one ``server_error_msg``
    chunk of ``error_code`` 1 (``Chat.generate_stream_gate``'s rule, which
    the engine worker's stream shares)."""
    try:
        yield from chunks
    except ValueError as e:
        print("Caught ValueError:", e)
        yield json_chunk(server_error_msg, 1)
    except Exception as e:
        print("Caught Unknown Error", e)
        yield json_chunk(server_error_msg, 1)
