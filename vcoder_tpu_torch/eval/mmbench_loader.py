"""MMBench multiple-choice answer generator.

A port of ``vcoder_tpu/eval/mmbench_loader.py``. It mirrors the reference
harness (reference: vcoder_llava/eval/model_vqa_mmbench.py): TSV questions
with base64 images, A/B/C/D option rendering with hint prefix, optional
all-rounds option rotation, the single-letter-answer instruction (en/cn),
and the same answers-jsonl record schema. The images are decoded by
``png.load_image_bytes`` (PNG by the port's decoder, JPEG by the native
library). Reading the TSV needs pandas: :func:`eval_model` raises
``ImportError`` naming it where it is missing. The model runs on
``--device`` (CUDA unless ``--device cpu``).

Usage:
    python -m vcoder_tpu_torch.eval.mmbench_loader --model-path ... \
        --question-file mmbench.tsv --answers-file out.jsonl \
        --single-pred-prompt
"""

from __future__ import annotations

import argparse
import base64
import json
import math
import os

import numpy as np

from vcoder_tpu_torch.builder import load_pretrained_model
from vcoder_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from vcoder_tpu_torch.conversation import SeparatorStyle, conv_templates
from vcoder_tpu_torch.eval import shortuuid_like
from vcoder_tpu_torch.eval.cost_loader import get_chunk
from vcoder_tpu_torch.mm_tokens import (
    get_model_name_from_path,
    tokenizer_image_token,
)
from vcoder_tpu_torch.png import load_image_bytes

ALL_OPTIONS = ["A", "B", "C", "D"]


def is_none(value) -> bool:
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    if isinstance(value, str) and value.lower() in ("nan", "none"):
        return True
    return False


def get_options(row, options):
    parsed = []
    for option in options:
        if is_none(row[option]):
            break
        parsed.append(row[option])
    return parsed


def load_image_from_base64(image: str) -> np.ndarray:
    """A base64 image -> ``[H, W, 3] uint8`` RGB (``png.load_image_bytes``)."""
    return load_image_bytes(base64.b64decode(image))


def eval_model(args):
    try:
        import pandas as pd
    except ImportError:
        raise ImportError(
            "the MMBench loader reads its TSV with pandas, which is not installed"
        ) from None

    model_path = os.path.expanduser(args.model_path)
    model_name = get_model_name_from_path(model_path)
    tokenizer, model, image_processor, _, _, _ = load_pretrained_model(
        model_path, args.model_base, model_name, device=getattr(args, "device", "cuda")
    )

    questions = pd.read_table(os.path.expanduser(args.question_file))
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    ans_file = open(answers_file, "w")

    conv_t = conv_templates[args.conv_mode]
    stop_str = (
        conv_t.sep if conv_t.sep_style != SeparatorStyle.TWO else conv_t.sep2
    )
    num_patches = model.config.vision.num_patches

    for _, row in questions.iterrows():
        options = get_options(row, ALL_OPTIONS)
        cur_option_char = ALL_OPTIONS[: len(options)]
        num_rounds = len(options) if args.all_rounds else 1

        for round_idx in range(num_rounds):
            idx = row["index"]
            question = row["question"]
            hint = row["hint"]
            image = load_image_from_base64(row["image"])
            if not is_none(hint):
                question = hint + "\n" + question
            for option_char, option in zip(
                ALL_OPTIONS[: len(options)], options
            ):
                question = question + "\n" + option_char + ". " + option
            cur_prompt = question
            qs = DEFAULT_IMAGE_TOKEN + "\n" + question
            if args.single_pred_prompt:
                if args.lang == "cn":
                    qs = qs + "\n" + "请直接回答选项字母。"
                else:
                    qs = (
                        qs + "\n" + "Answer with the option's letter from"
                        " the given choices directly."
                    )

            conv = conv_t.copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            ids = list(tokenizer_image_token(prompt, tokenizer))
            px = image_processor.preprocess(image)["pixel_values"]
            pad_to = -(-(len(ids) + num_patches) // 256) * 256
            result = model.generate(
                [ids],
                images=px,
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature,
                top_p=args.top_p if args.top_p is not None else 1.0,
                do_sample=args.temperature > 0,
                tokenizer=tokenizer,
                pad_to=pad_to,
                num_beams=getattr(args, "num_beams", 1),
            )
            outputs = result.texts[0].strip()
            if stop_str and outputs.endswith(stop_str):
                outputs = outputs[: -len(stop_str)]
            ans_file.write(
                json.dumps(
                    {
                        "question_id": int(idx),
                        "round_id": round_idx,
                        "prompt": cur_prompt,
                        "text": outputs.strip(),
                        "options": options,
                        "option_char": cur_option_char,
                        "answer_id": shortuuid_like.uuid(),
                        "model_id": model_name,
                        "metadata": {},
                    }
                )
                + "\n"
            )
            ans_file.flush()
            # rotate options for the next round
            options = options[1:] + options[:1]
            cur_option_char = cur_option_char[1:] + cur_option_char[:1]
    ans_file.close()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-folder", type=str, default="")
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, default="answer.jsonl")
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--max-new-tokens", type=int, default=128)
    parser.add_argument("--all-rounds", action="store_true")
    parser.add_argument("--single-pred-prompt", action="store_true")
    parser.add_argument("--lang", type=str, default="en")
    parser.add_argument("--device", type=str, default="cuda")
    eval_model(parser.parse_args())


if __name__ == "__main__":
    main()
