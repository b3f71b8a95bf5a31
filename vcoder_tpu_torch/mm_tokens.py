"""Multimodal tokenization: splicing sentinel token ids into text token streams.

These functions mirror the observable behavior of the reference tokenizer
helpers (reference: vcoder_llava/mm_utils.py:43-117) but return plain Python
lists / numpy arrays instead of torch tensors. They work with any
HF-protocol tokenizer (``tokenizer(text).input_ids`` + ``bos_token_id``).

Exact sentinel-cluster orderings produced (verified against the reference):

* ``tokenizer_image_token``:      ``... [-200] ...``
* ``tokenizer_seg_token``:        ``... [-200, -300] ...``    (image, seg)
* ``tokenizer_depth_seg_token`` with ``<depth>`` in prompt:
                                  ``... [-200, -400, -300] ...`` (image, depth, seg)

The last ordering comes from the reference's separator-slicing quirk
(mm_utils.py:101-105) and is what makes the model's splice drop the depth
features downstream — see multimodal.py for details.

A copy of ``vcoder_tpu/mm_tokens.py`` for the PyTorch port, which imports nothing
of ``vcoder_tpu``; keep the two in step.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from vcoder_tpu_torch.constants import (
    DEPTH_TOKEN_INDEX,
    IMAGE_TOKEN_INDEX,
    SEG_TOKEN_INDEX,
)


def _encode_chunks(prompt: str, sep: str, tokenizer) -> List[List[int]]:
    return [list(tokenizer(chunk).input_ids) for chunk in prompt.split(sep)]


def _has_leading_bos(chunks: Sequence[Sequence[int]], tokenizer) -> bool:
    return (
        len(chunks) > 0
        and len(chunks[0]) > 0
        and chunks[0][0] == tokenizer.bos_token_id
    )


def _maybe_np(input_ids: List[int], return_tensors: Optional[str]):
    if return_tensors is None:
        return input_ids
    if return_tensors == "np":
        return np.asarray(input_ids, dtype=np.int64)
    raise ValueError(f"Unsupported tensor type: {return_tensors}")


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Tokenize ``prompt``, replacing each ``<image>`` with the sentinel id.

    reference: vcoder_llava/mm_utils.py:43-62
    """
    chunks = _encode_chunks(prompt, "<image>", tokenizer)
    offset = 1 if _has_leading_bos(chunks, tokenizer) else 0

    input_ids: List[int] = []
    if offset:
        input_ids.append(chunks[0][0])
    for i, chunk in enumerate(chunks):
        if i > 0:
            # Reference inserts (offset+1) copies of the sentinel between
            # chunks but then skips `offset` leading elements of each list it
            # concatenates — net effect: exactly one sentinel per boundary.
            input_ids.append(image_token_index)
        input_ids.extend(chunk[offset:])
    return _maybe_np(input_ids, return_tensors)


def tokenizer_seg_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    seg_token_index: int = SEG_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Tokenize, replacing each ``<seg>\\n<image>`` with ``[-200, -300]``.

    The reference builds a separator ``[seg, image] * (offset+1)`` and slices
    it with ``x[offset:-1]`` (mm_utils.py:77-81), which for offset=1 yields
    ``[image, seg]`` — i.e. the *image* sentinel precedes the *seg* sentinel
    in the output ids even though ``<seg>`` precedes ``<image>`` in text.
    For offset=0 the slice ``x[0:-1]`` of ``[seg, image]`` yields ``[seg]``
    only; we reproduce both behaviors.
    """
    chunks = _encode_chunks(prompt, "<seg>\n<image>", tokenizer)
    offset = 1 if _has_leading_bos(chunks, tokenizer) else 0

    sep = [seg_token_index, image_token_index] * (offset + 1)
    boundary = sep[offset:-1]  # offset=1 -> [image, seg]; offset=0 -> [seg]

    input_ids: List[int] = []
    if offset:
        input_ids.append(chunks[0][0])
    for i, chunk in enumerate(chunks):
        if i > 0:
            input_ids.extend(boundary)
        input_ids.extend(chunk[offset:])
    return _maybe_np(input_ids, return_tensors)


def _tokenizer_depth_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    seg_token_index: int = SEG_TOKEN_INDEX,
    depth_token_index: int = DEPTH_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Tokenize, replacing ``<depth>\\n<seg>\\n<image>`` with
    ``[-200, -400, -300]`` (image, depth, seg).

    The reference separator is ``[image, depth, seg] * (offset+1)`` sliced
    with ``x[:3]`` (mm_utils.py:101-103), independent of offset.
    """
    chunks = _encode_chunks(prompt, "<depth>\n<seg>\n<image>", tokenizer)
    offset = 1 if _has_leading_bos(chunks, tokenizer) else 0

    boundary = [image_token_index, depth_token_index, seg_token_index]

    input_ids: List[int] = []
    if offset:
        input_ids.append(chunks[0][0])
    for i, chunk in enumerate(chunks):
        if i > 0:
            input_ids.extend(boundary)
        input_ids.extend(chunk[offset:])
    return _maybe_np(input_ids, return_tensors)


def tokenizer_depth_seg_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    seg_token_index: int = SEG_TOKEN_INDEX,
    depth_token_index: int = DEPTH_TOKEN_INDEX,
    return_tensors: Optional[str] = None,
):
    """Dispatch on presence of ``<depth>`` (reference: mm_utils.py:113-117)."""
    if "<depth>" in prompt:
        return _tokenizer_depth_token(
            prompt,
            tokenizer,
            image_token_index,
            seg_token_index,
            depth_token_index,
            return_tensors,
        )
    return tokenizer_seg_token(
        prompt, tokenizer, image_token_index, seg_token_index, return_tensors
    )


def get_model_name_from_path(model_path: str) -> str:
    """reference: vcoder_llava/mm_utils.py:120-126"""
    model_path = model_path.strip("/")
    model_paths = model_path.split("/")
    if model_paths[-1].startswith("checkpoint-"):
        return model_paths[-2] + "_" + model_paths[-1]
    return model_paths[-1]


class KeywordsStoppingCriteria:
    """Host-side stop-string check over generated tails.

    Equivalent to the reference's HF StoppingCriteria (mm_utils.py:128-151)
    but framework-free: feed it the full generated id list (prompt included)
    and it reports whether any keyword terminates the output.
    """

    def __init__(self, keywords: Sequence[str], tokenizer, input_len: int):
        self.keywords = list(keywords)
        self.keyword_ids: List[List[int]] = []
        for keyword in self.keywords:
            ids = list(tokenizer(keyword).input_ids)
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.keyword_ids.append(ids)
        self.tokenizer = tokenizer
        self.start_len = input_len

    def __call__(self, output_ids: Sequence[int]) -> bool:
        output_ids = list(output_ids)
        for kw_ids in self.keyword_ids:
            if len(output_ids) >= len(kw_ids) and output_ids[-len(kw_ids):] == kw_ids:
                return True
        offset = min(len(output_ids) - self.start_len, 3)
        if offset <= 0:
            return False
        tail = self.tokenizer.decode(
            output_ids[-offset:], skip_special_tokens=True
        )
        return any(kw in tail for kw in self.keywords)
