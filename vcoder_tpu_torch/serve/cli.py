"""Interactive CLI (port of ``vcoder_tpu/serve/cli.py``).

Loads the model, preprocesses the image (and the seg and depth maps) once,
injects ``<depth>\\n<seg>\\n<image>\\n`` on the first turn, streams the tokens
to stdout and keeps the conversation across turns. Greedy requests
(``--temperature 0``) stream through prompt-lookup speculative decoding
(``--lookahead 8``; below 2 disables it). PNG files are decoded without PIL
(``png.load_image_bytes``); there is no network, so an ``http(s)://`` path
raises.

    python -m vcoder_tpu_torch.serve.cli --model-path <ckpt dir> \\
        --image-file img.png [--seg-file seg.png] [--depth-file d.png]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from vcoder_tpu_torch import generation as gen_mod
from vcoder_tpu_torch.builder import load_pretrained_model
from vcoder_tpu_torch.constants import DEFAULT_DEPTH_TOKEN, DEFAULT_IMAGE_TOKEN, DEFAULT_SEG_TOKEN
from vcoder_tpu_torch.conversation import SeparatorStyle, conv_templates
from vcoder_tpu_torch.mm_tokens import (
    get_model_name_from_path,
    tokenizer_depth_seg_token,
    tokenizer_image_token,
)
from vcoder_tpu_torch.png import load_image_bytes
from vcoder_tpu_torch.utils import disable_torch_init


def load_image(image_file: str) -> np.ndarray:
    """An image file -> ``[H, W, 3] uint8`` RGB."""
    if image_file.startswith(("http://", "https://")):
        raise ValueError(f"cannot fetch {image_file}: pass a local file (no network)")
    with open(image_file, "rb") as f:
        return load_image_bytes(f.read())


def main(args):
    disable_torch_init()

    model_name = get_model_name_from_path(args.model_path)
    (
        tokenizer,
        model,
        image_processor,
        seg_image_processor,
        depth_image_processor,
        context_len,
    ) = load_pretrained_model(
        args.model_path, args.model_base, model_name, args.load_8bit, args.load_4bit,
        device=args.device,
    )
    if tokenizer is None:
        print("error: no tokenizer files in the checkpoint directory", file=sys.stderr)
        sys.exit(1)

    conv_mode = "llava_v1"
    if args.conv_mode is not None and conv_mode != args.conv_mode:
        print(
            "[WARNING] the auto inferred conversation mode is {}, while `--conv-mode` is {}, "
            "using {}".format(conv_mode, args.conv_mode, args.conv_mode)
        )
    else:
        args.conv_mode = conv_mode

    conv = conv_templates[args.conv_mode].copy()
    roles = conv.roles
    ar = {"image_aspect_ratio": args.image_aspect_ratio}

    image = load_image(args.image_file)
    image_tensor = image_processor.preprocess(image, **ar)["pixel_values"]

    seg_image = seg_image_tensor = None
    if args.seg_file is not None and seg_image_processor is not None:
        seg_image = load_image(args.seg_file)
        seg_image_tensor = seg_image_processor.preprocess(seg_image, **ar)["pixel_values"]

    depth_image = depth_image_tensor = None
    if args.depth_file is not None and depth_image_processor is not None:
        depth_image = load_image(args.depth_file)
        depth_image_tensor = depth_image_processor.preprocess(depth_image, **ar)["pixel_values"]

    while True:
        try:
            inp = input(f"{roles[0]}: ")
        except EOFError:
            inp = ""
        if not inp:
            print("exit...")
            break

        print(f"{roles[1]}: ", end="", flush=True)

        if image is not None:
            # First turn: sentinels in depth -> seg -> image order.
            inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
            image = None
            if seg_image is not None:
                inp = DEFAULT_SEG_TOKEN + "\n" + inp
                seg_image = None
                if depth_image is not None:
                    inp = DEFAULT_DEPTH_TOKEN + "\n" + inp
                    depth_image = None
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        if "<seg>" not in prompt:
            input_ids = tokenizer_image_token(prompt, tokenizer)
        else:
            input_ids = tokenizer_depth_seg_token(prompt, tokenizer)

        stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2

        prev = ""
        outputs = ""
        for text in gen_mod.generate_stream(
            model.params,
            model.config,
            [list(input_ids)],
            image_tensor,
            seg_image_tensor,
            depth_image_tensor,
            tokenizer=tokenizer,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            stop_str=stop_str,
            lookahead=args.lookahead,
        ):
            print(text[len(prev):], end="", flush=True)
            prev = text
            outputs = text
        print()
        conv.messages[-1][-1] = outputs.strip()

        if args.debug:
            print("\n", {"prompt": prompt, "outputs": outputs}, "\n")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="shi-labs/vcoder_ds_llava-v1.5-13b")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-file", type=str, required=True)
    parser.add_argument("--seg-file", type=str, default=None)
    parser.add_argument("--depth-file", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--conv-mode", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument(
        "--lookahead", type=int, default=8,
        help="speculative decoding window for greedy (--temperature 0) streaming; <2 disables",
    )
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--image-aspect-ratio", type=str, default="pad")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
