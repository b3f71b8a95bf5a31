"""Generic VQA jsonl answer generator (POPE / VQAv2 / GQA / VizWiz / MME).

A port of ``vcoder_tpu/eval/vqa_loader.py``. It mirrors the reference
harness' jsonl protocol (reference: vcoder_llava/eval/model_vqa_loader.py,
model_vqa_mme.py): question file lines carry {question_id, image, text};
answers lines carry {question_id, prompt, text, answer_id, model_id,
metadata}. Questions are generated in batches of ``--batch-size`` rows
through ``VCoderForCausalLM.generate``; ``--num-chunks``/``--chunk-idx``
keep the sharding contract of scripts/v1_5/eval/*.sh. Files are read by
``preprocess.load_images_preprocessed`` (the native library); the model
runs on ``--device`` (CUDA unless ``--device cpu``).

Usage:
    python -m vcoder_tpu_torch.eval.vqa_loader --model-path ... \
        --question-file q.jsonl --image-folder ... --answers-file a.jsonl
"""

from __future__ import annotations

import argparse
import json
import os

from vcoder_tpu_torch.builder import load_pretrained_model
from vcoder_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
from vcoder_tpu_torch.conversation import SeparatorStyle, conv_templates
from vcoder_tpu_torch.eval.cost_loader import get_chunk
from vcoder_tpu_torch.eval import shortuuid_like
from vcoder_tpu_torch.mm_tokens import (
    get_model_name_from_path,
    tokenizer_image_token,
)
from vcoder_tpu_torch.preprocess import load_images_preprocessed


def _round_up(n, m):
    return -(-n // m) * m


def eval_model(args):
    model_path = os.path.expanduser(args.model_path)
    model_name = get_model_name_from_path(model_path)
    tokenizer, model, image_processor, _, _, _ = load_pretrained_model(
        model_path, args.model_base, model_name, device=getattr(args, "device", "cuda")
    )

    questions = [
        json.loads(q)
        for q in open(os.path.expanduser(args.question_file), "r")
    ]
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    ans_file = open(answers_file, "w")

    conv_t = conv_templates[args.conv_mode]
    stop_str = (
        conv_t.sep if conv_t.sep_style != SeparatorStyle.TWO else conv_t.sep2
    )

    B = args.batch_size
    num_patches = model.config.vision.num_patches
    for start in range(0, len(questions), B):
        lines = questions[start : start + B]
        rows, paths = [], []
        for line in lines:
            qs = line["text"]
            if args.single_pred_prompt:
                qs += (
                    "\nAnswer the question using a single word or phrase."
                )
            qs = DEFAULT_IMAGE_TOKEN + "\n" + qs
            conv = conv_t.copy()
            conv.append_message(conv.roles[0], qs)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            paths.append(os.path.join(args.image_folder, line["image"]))
            rows.append(list(tokenizer_image_token(prompt, tokenizer)))

        # Batched native decode+preprocess (threaded C++) — see
        # preprocess.load_images_preprocessed.
        pixels = load_images_preprocessed(
            paths,
            size=getattr(image_processor, "size", 336),
            image_aspect_ratio=getattr(image_processor, "image_aspect_ratio", "pad"),
            device=image_processor.device,
        )

        pad_to = _round_up(
            max(len(r) for r in rows) + num_patches, 256
        )
        result = model.generate(
            rows,
            images=pixels,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            top_p=args.top_p if args.top_p is not None else 1.0,
            do_sample=args.temperature > 0,
            tokenizer=tokenizer,
            pad_to=pad_to,
            lookahead=getattr(args, "lookahead", 0),
            num_beams=getattr(args, "num_beams", 1),
        )
        for line, text in zip(lines, result.texts):
            outputs = text.strip()
            if stop_str and outputs.endswith(stop_str):
                outputs = outputs[: -len(stop_str)]
            ans_file.write(
                json.dumps(
                    {
                        "question_id": line["question_id"],
                        "prompt": line["text"],
                        "text": outputs.strip(),
                        "answer_id": shortuuid_like.uuid(),
                        "model_id": model_name,
                        "metadata": {},
                    }
                )
                + "\n"
            )
        ans_file.flush()
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
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument(
        "--lookahead", type=int, default=0,
        help="prompt-lookup speculative decoding window (greedy only; "
        ">=2 enables, 0 disables — identical outputs either way)",
    )
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--single-pred-prompt", action="store_true",
        help="append the single-word-answer instruction (the reference passes this ONLY for MMBench; MME questions already carry their own instruction)",
    )
    eval_model(parser.parse_args())


if __name__ == "__main__":
    main()
