"""The request record the engine worker consumes (``PreparedRequest``, a copy
of ``vcoder_tpu/serve/chat.py:43``). ``Chat`` -- the checkpoint-loading,
wire-protocol front end that fills it -- waits for the surfaces slice."""

from __future__ import annotations

import dataclasses
from typing import List, Optional


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
