"""GPT-4V baseline answer generator for COST images.

A copy of ``vcoder_tpu/eval/gpt4_query.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step. It needs no device;
``requests`` is imported only when a query is sent.

Mirrors the reference (reference: vcoder_llava/eval/gpt4_query.py): sends
each val2017 image to the OpenAI vision endpoint with the count-format
prompt and records answers in the standard loader txt format for the
GPT-4 CS/HS scorer. Requires OPENAI_API_KEY and network access.

Usage: python -m vcoder_tpu_torch.eval.gpt4_query --image-folder ... --output-file out
"""

from __future__ import annotations

import argparse
import base64
import glob
import os
import time

PROMPT = (
    "What entities can be seen in the image? Your answer should be in the"
    " format: 'The objects present in the image are: ...' and then just"
    " list the objects with their counts (in words) before them in"
    " paragraph format. For example if there are 14 people, two dogs, and"
    " three chairs in an image, you should respond: The objects present"
    " in are: fourteen people, two dogs, three chairs."
)


def query_gpt4(image_path: str, api_key: str, model: str):
    import requests

    with open(image_path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode("utf-8")
    payload = {
        "model": model,
        "messages": [
            {
                "role": "user",
                "content": [
                    {"type": "text", "text": PROMPT},
                    {
                        "type": "image_url",
                        "image_url": {
                            "url": f"data:image/jpeg;base64,{b64}"
                        },
                    },
                ],
            }
        ],
        "max_tokens": 300,
    }
    headers = {
        "Content-Type": "application/json",
        "Authorization": f"Bearer {api_key}",
    }
    r = requests.post(
        "https://api.openai.com/v1/chat/completions",
        headers=headers,
        json=payload,
        timeout=60,
    )
    return r.json()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--image-folder", type=str, default="")
    parser.add_argument("--output-file", type=str, default="output")
    parser.add_argument("--model", type=str, default="gpt-4-vision-preview")
    parser.add_argument("--sleep", type=float, default=1.0)
    args = parser.parse_args()

    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        raise SystemExit("OPENAI_API_KEY is required")

    images = sorted(glob.glob(os.path.join(args.image_folder, "*.jpg")))
    for task in ("semantic", "instance", "panoptic"):
        out = f"{args.output_file}_{task}.txt"
        with open(out, "a") as f:
            for path in images:
                key = os.path.basename(path)
                try:
                    res = query_gpt4(path, api_key, args.model)
                    answer = res["choices"][0]["message"]["content"]
                except Exception as e:
                    print(f"error on {key}: {e}")
                    continue
                f.write(f"Image: {key}\n")
                f.write(f"<<QUESTION>>: {PROMPT}\n")
                f.write(f"<<ANSWER>>: {answer}\n")
                f.write("-" * 55 + "\n")
                time.sleep(args.sleep)


if __name__ == "__main__":
    main()
