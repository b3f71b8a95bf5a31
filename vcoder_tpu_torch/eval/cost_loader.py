"""COST evaluation answer generator (seg + depth variants).

A port of ``vcoder_tpu/eval/cost_loader.py``. It mirrors the reference
loaders' behavior and record format (reference:
vcoder_llava/eval/model_seg_loader.py, model_depth_loader.py), but
generates the images in **batches** of ``--batch-size`` rows through
``VCoderForCausalLM.generate`` instead of the reference's batch-1
DataLoader. The chunking (``--num-chunks/--chunk-idx``, ``split_list``,
``get_chunk``), the answers file's name, the question choice
(``random.Random(seed + chunk_idx)``), the prompt order
(``<depth>\n<seg>\n<image>\n`` + question), ``pad_to`` and the record
format are the JAX loader's. Files are read by
``preprocess.load_images_preprocessed`` (the native library). The model
runs on ``--device`` (CUDA unless ``--device cpu``).

Usage:
    python -m vcoder_tpu_torch.eval.cost_loader --model-path ... \
        --image-folder .../val2017 --seg-image-folder .../<task>_inference \
        --output-file output [--use-depth --depth-image-folder ...]
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import random
from typing import List, Optional

import torch

from vcoder_tpu_torch.builder import load_pretrained_model
from vcoder_tpu_torch.constants import (
    DEFAULT_DEPTH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_SEG_TOKEN,
)
from vcoder_tpu_torch.conversation import SeparatorStyle, conv_templates
from vcoder_tpu_torch.mm_tokens import (
    get_model_name_from_path,
    tokenizer_depth_seg_token,
    tokenizer_image_token,
    tokenizer_seg_token,
)
from vcoder_tpu_torch.preprocess import load_images_preprocessed
from vcoder_tpu_torch.questions import (
    DEPTH_PARAGRAPH_SUFFIX,
    QUESTIONS,
    SEG_PARAGRAPH_SUFFIX,
)


def split_list(lst, n):
    """reference: model_seg_loader.py:23-27"""
    chunk_size = math.ceil(len(lst) / n)
    return [lst[i : i + chunk_size] for i in range(0, len(lst), chunk_size)]


def get_chunk(lst, n, k):
    return split_list(lst, n)[k]


def _round_up(n, m):
    return -(-n // m) * m


def _batch_pixels(paths: List[str], processor) -> torch.Tensor:
    """[N, S, S, 3] f32 pixels on the processor's device for a list of
    files, honoring the processor's size/aspect (native threaded decode)."""
    return load_images_preprocessed(
        paths,
        size=getattr(processor, "size", 336),
        image_aspect_ratio=getattr(processor, "image_aspect_ratio", "pad"),
        device=processor.device,
    )


def eval_model(args, task: str) -> str:
    model_name = get_model_name_from_path(args.model_path)
    (
        tokenizer,
        model,
        image_processor,
        seg_image_processor,
        depth_image_processor,
        _,
    ) = load_pretrained_model(
        args.model_path, args.model_base, model_name,
        device=getattr(args, "device", "cuda"),
    )

    use_seg = args.use_seg and "vcoder" in model_name.lower()
    use_depth = args.use_depth and "ds" in model_name.lower()
    if use_depth and not use_seg:
        # Depth features ride the seg branch (the reference makes this
        # state unrepresentable: model_depth_loader.py:54 raises for
        # seg-without-depth); silently ignoring --use-depth would write
        # a valid-looking but depth-blind answers file.
        raise SystemExit(
            "--use-depth requires --use-seg (and a vcoder model)"
        )

    images = sorted(glob.glob(os.path.join(args.image_folder, "*.jpg")))
    images = get_chunk(images, args.num_chunks, args.chunk_idx)
    max_samples = getattr(args, "max_samples", None)
    if max_samples:
        images = images[: int(max_samples)]

    seg_folder = None
    if use_seg:
        seg_folder = args.seg_image_folder.replace("$TASK", task)
    depth_folder = args.depth_image_folder if use_depth else None

    questions = QUESTIONS[task]
    conv_t = conv_templates[args.conv_mode]
    stop_str = (
        conv_t.sep if conv_t.sep_style != SeparatorStyle.TWO else conv_t.sep2
    )

    rng = random.Random(args.seed + args.chunk_idx)
    # Reference filename contract (model_seg_loader.py:109): every chunk
    # process shares ONE --output-file and appends its own
    # _{task}_{num_chunks}_{chunk_idx}.txt — without the suffix two
    # chunks truncate/interleave each other's records.
    answers_file = (
        f"{args.output_file}_{task}_{args.num_chunks}_{args.chunk_idx}.txt"
    )
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    open(answers_file, "w").close()

    B = args.batch_size
    for start in range(0, len(images), B):
        batch_files = images[start : start + B]
        rows, keys, quests = [], [], []
        seg_paths, depth_paths = [], []
        for image_file in batch_files:
            key = os.path.basename(image_file)
            ques = rng.choice(questions)
            qs = DEFAULT_IMAGE_TOKEN + "\n" + ques
            if seg_folder is not None:
                seg_paths.append(os.path.join(seg_folder, key))
                qs = DEFAULT_SEG_TOKEN + "\n" + qs
                if depth_folder is not None:
                    depth_paths.append(os.path.join(depth_folder, key))
                    qs = DEFAULT_DEPTH_TOKEN + "\n" + qs
            else:
                # No-seg fallback appends the paragraph-format instruction
                # (reference: model_seg_loader.py:73, model_depth_loader.py:90).
                qs = qs + (
                    DEPTH_PARAGRAPH_SUFFIX
                    if task == "depth"
                    else SEG_PARAGRAPH_SUFFIX
                )

            conv = conv_t.copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            if depth_folder is not None and seg_folder is not None:
                ids = tokenizer_depth_seg_token(prompt, tokenizer)
            elif seg_folder is not None:
                ids = tokenizer_seg_token(prompt, tokenizer)
            else:
                ids = tokenizer_image_token(prompt, tokenizer)
            rows.append(list(ids))
            keys.append(key)
            quests.append(ques)

        # Batched decode+pad+resize+normalize per modality through the
        # native threaded pipeline (preprocess.load_images_preprocessed).
        # The reference decodes batch-1 via a PIL DataLoader
        # (model_seg_loader.py:92-96).
        px_i = _batch_pixels(batch_files, image_processor)
        px_s = (
            _batch_pixels(seg_paths, seg_image_processor)
            if seg_paths
            else []
        )
        px_d = (
            _batch_pixels(depth_paths, depth_image_processor)
            if depth_paths
            else []
        )

        n_mod = 1 + int(len(px_s) > 0) + int(len(px_d) > 0)
        max_len = max(len(r) for r in rows) + n_mod * self_num_patches(model)
        pad_to = _round_up(max_len, 256)

        result = model.generate(
            rows,
            images=px_i,
            segs=px_s if len(px_s) > 0 else None,
            depths=px_d if len(px_d) > 0 else None,
            max_new_tokens=512,
            temperature=args.temperature,
            top_p=args.top_p if args.top_p is not None else 1.0,
            do_sample=args.temperature > 0,
            tokenizer=tokenizer,
            pad_to=pad_to,
            lookahead=getattr(args, "lookahead", 0),
            num_beams=getattr(args, "num_beams", 1),
        )
        with open(answers_file, "a") as f:
            for key, ques, text in zip(keys, quests, result.texts):
                outputs = text.strip()
                if stop_str and outputs.endswith(stop_str):
                    outputs = outputs[: -len(stop_str)]
                outputs = outputs.strip().strip("\n")
                f.write(f"Image: {key}\n")
                f.write(f"<<QUESTION>>: {ques}\n")
                f.write(f"<<ANSWER>>: {outputs}\n")
                f.write("-" * 55 + "\n")
    return answers_file


def self_num_patches(model) -> int:
    return model.config.vision.num_patches


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-folder", type=str, default="")
    parser.add_argument("--use_seg", "--use-seg", dest="use_seg",
                        action="store_true")
    parser.add_argument(
        "--seg-image-folder",
        type=str,
        default="",
        help="Path to <task>_inference dirs; use $TASK as placeholder",
    )
    parser.add_argument("--use_depth", "--use-depth", dest="use_depth",
                        action="store_true")
    parser.add_argument("--depth-image-folder", type=str, default="")
    parser.add_argument("--output-file", type=str, default="output")
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--lookahead", type=int, default=0,
        help="prompt-lookup speculative decoding window (greedy only; "
        ">=2 enables, 0 disables — identical outputs either way)",
    )
    parser.add_argument(
        "--max-samples", type=int, default=None,
        help="cap images per task (subset runs, e.g. the parity runbook)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--tasks",
        type=str,
        default="semantic,instance,panoptic",
        help="comma-separated; use 'depth' for the depth-order eval",
    )
    return parser


def main():
    args = build_parser().parse_args()

    for task in args.tasks.split(","):
        out = eval_model(args, task.strip())
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
