"""Training conversation preprocessing: prompt render + instruction masking.

One parameterized implementation covering the reference's three near-
identical variants (reference: train/train.py:415-489 ``preprocess_v1``,
train/vcoder_train.py:143-227 ``vcoder_preprocess_v1``,
train/vcoder_ds_train.py:152-245 ``depth_seg_preprocess_v1``) plus
``preprocess_plain`` (train.py:560-578) and the sentinel-relocation pass
(``preprocess_multimodal`` family, train.py:604-625,
vcoder_train.py:228-252, vcoder_ds_train.py:246-280).

Semantics preserved exactly:

* vicuna-v1 TWO-style render, rounds split on ``</s>``, instruction span
  masked to IGNORE_INDEX with the ``-2`` offset (``-3`` when the round
  carries a depth sentinel — the reference's depth fudge,
  vcoder_ds_train.py:215-217);
* tokenization mismatch -> whole target masked with a warning;
* sentinel tokens relocated to the front of the message in
  image -> seg -> depth order.

Everything returns plain Python lists (the static-shape collator feeds
them to build_splice_plan).

A copy of ``vcoder_tpu/train/preprocess.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from vcoder_tpu_torch.constants import (
    DEFAULT_DEPTH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_SEG_TOKEN,
    IGNORE_INDEX,
)
from vcoder_tpu_torch.conversation import SeparatorStyle, conv_templates
from vcoder_tpu_torch.mm_tokens import (
    tokenizer_depth_seg_token,
    tokenizer_image_token,
    tokenizer_seg_token,
)


def relocate_sentinels(
    sources: Sequence[List[dict]],
    *,
    use_seg: bool = False,
    use_depth: bool = False,
) -> Sequence[List[dict]]:
    """Move each sentinel to the front of its message, image->seg->depth.

    reference: preprocess_multimodal (train.py:604-625) and the vcoder/ds
    variants. Mutates and returns ``sources``.
    """
    tokens = [DEFAULT_IMAGE_TOKEN]
    if use_seg:
        tokens.append(DEFAULT_SEG_TOKEN)
    if use_depth:
        tokens.append(DEFAULT_DEPTH_TOKEN)
    for source in sources:
        for sentence in source:
            for tok in tokens:
                if tok in sentence["value"]:
                    sentence["value"] = (
                        tok
                        + "\n"
                        + sentence["value"].replace(tok, "").strip()
                    ).strip()
    return sources


def _mm_tokenize(prompt: str, tokenizer, mode: str) -> List[int]:
    if mode == "depth_seg":
        return list(tokenizer_depth_seg_token(prompt, tokenizer))
    if mode == "seg":
        return list(tokenizer_seg_token(prompt, tokenizer))
    if mode == "image":
        return list(tokenizer_image_token(prompt, tokenizer))
    return list(tokenizer(prompt).input_ids)


def _render_conversations(sources, conv) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for i, source in enumerate(sources):
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], f"{i}"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def preprocess_v1(
    sources,
    tokenizer,
    *,
    mode: str = "text",  # text | image | seg | depth_seg
    conv=None,
    model_max_length: int = 2048,
) -> Dict[str, List[List[int]]]:
    """Vicuna-v1 preprocessing with instruction masking."""
    conv = (conv or conv_templates["vicuna_v1"]).copy()
    conversations = _render_conversations(sources, conv)
    assert conv.sep_style == SeparatorStyle.TWO

    input_ids = [
        _mm_tokenize(prompt, tokenizer, mode)[:model_max_length]
        for prompt in conversations
    ]
    targets = [list(ids) for ids in input_ids]

    sep = conv.sep + conv.roles[1] + ": "
    # The reference's depth variant subtracts 3 instead of 2 for EVERY
    # round of a depth conversation (conversation-level has_depth flag,
    # vcoder_ds_train.py:214-217) — not just rounds containing the
    # sentinel. The deliberate -3 fudge itself stays (pinned in ROADMAP.md).
    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = [IGNORE_INDEX] * cur_len
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            offset = 3 if mode == "depth_seg" else 2
            round_len = len(_mm_tokenize(rou, tokenizer, mode))
            instruction_len = (
                len(_mm_tokenize(parts[0], tokenizer, mode)) - offset
            )
            end = min(cur_len + instruction_len, len(target))
            target[cur_len:end] = [IGNORE_INDEX] * (end - cur_len)
            cur_len += round_len
        if cur_len < len(target):
            target[cur_len:] = [IGNORE_INDEX] * (len(target) - cur_len)
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = [IGNORE_INDEX] * len(target)
            print(
                f"WARNING: tokenization mismatch: {cur_len} vs."
                f" {total_len}. (ignored)"
            )

    return dict(input_ids=input_ids, labels=targets)


def preprocess_plain(sources, tokenizer, conv=None):
    """Pretrain-stage preprocessing (reference: train.py:560-578):
    '<image>' + caption + sep; labels mask the image span."""
    conv = (conv or conv_templates["plain"]).copy()
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        source[0]["value"] = DEFAULT_IMAGE_TOKEN
        conversation = (
            source[0]["value"] + source[1]["value"] + conv.sep
        )
        conversations.append(conversation)
    input_ids = [
        list(tokenizer_image_token(prompt, tokenizer))
        for prompt in conversations
    ]
    targets = [list(ids) for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_len = len(
            tokenizer_image_token(source[0]["value"], tokenizer)
        )
        target[:tokenized_len] = [IGNORE_INDEX] * tokenized_len
    return dict(input_ids=input_ids, labels=targets)


def preprocess(
    sources,
    tokenizer,
    *,
    has_image: bool = False,
    has_seg: bool = False,
    has_depth: bool = False,
    version: str = "v1",
    model_max_length: int = 2048,
) -> Dict[str, List[List[int]]]:
    """Dispatcher mirroring the reference ``preprocess`` functions
    (train.py:580-599, vcoder_train.py:253+, vcoder_ds_train.py:281+)."""
    if version == "plain":
        return preprocess_plain(sources, tokenizer)
    if has_image and has_seg and has_depth:
        mode = "depth_seg"
    elif has_image and has_seg:
        mode = "seg"
    elif has_image:
        mode = "image"
    else:
        mode = "text"
    if version not in conv_templates:
        raise ValueError(f"unknown conversation version {version!r}")
    # Dispatch on the configured template like the reference's
    # default_conversation: llava_v1 has a different system prompt than
    # vicuna_v1 — ignoring `version` would silently train on the wrong
    # prompt.
    return preprocess_v1(
        sources,
        tokenizer,
        mode=mode,
        conv=conv_templates[version],
        model_max_length=model_max_length,
    )
