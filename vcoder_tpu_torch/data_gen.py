"""GPT-4-assisted instruction-data generation from the prompt seeds.

A copy of ``vcoder_tpu/data_gen.py`` for the PyTorch port, which imports
nothing of ``vcoder_tpu``; keep the two in step. It needs no device: the
default mode writes request payloads offline, and ``requests`` is imported
only when ``--query`` sends them.

The LLaVA training mix the reference consumes was produced by querying
GPT-4 with few-shot seed prompts (playground/data/prompts/ — carried over
verbatim as data: the seeds define the generated-data distribution, so
paraphrasing them would change the dataset). The reference ships the
seeds without a driver; this module makes them executable: it assembles
the exact few-shot message list for each task type and either emits
request payloads as jsonl (for offline batch submission) or, with
OPENAI_API_KEY and network access, queries the chat endpoint directly —
same transport conventions as eval/gpt4_query.py.

Task types (= seed subdirectories):
* ``conversation``       — multi-turn Q/A about the image
* ``detail_description`` — single detailed caption
* ``complex_reasoning``  — background-knowledge / reasoning Q/A

Input: a jsonl of ``{"id": ..., "caps": "five caption lines..."}``
records (COCO-style captions, optionally with box lines, exactly what the
seed ``*_caps.txt`` files contain).

Usage:
    python -m vcoder_tpu_torch.data_gen --type conversation \
        --caps-file caps.jsonl --out requests.jsonl          # payloads
    python -m vcoder_tpu_torch.data_gen --type conversation \
        --caps-file caps.jsonl --out answers.jsonl --query   # live GPT-4
"""

from __future__ import annotations

import argparse
import glob
import json
import os

TASK_TYPES = ("conversation", "detail_description", "complex_reasoning")
DEFAULT_SEED_DIR = os.path.join("playground", "data", "prompts")


def load_seeds(seed_dir: str, task_type: str):
    """Read system message + ordered few-shot (caps, conv) pairs."""
    root = os.path.join(seed_dir, task_type)
    with open(os.path.join(root, "system_message.txt")) as f:
        system_message = f.read()
    shots = []
    for caps_path in sorted(glob.glob(os.path.join(root, "*_caps.txt"))):
        conv_path = caps_path.replace("_caps.txt", "_conv.txt")
        with open(caps_path) as f:
            caps = f.read()
        with open(conv_path) as f:
            conv = f.read()
        shots.append((caps, conv))
    if not shots:
        raise FileNotFoundError(f"no few-shot seeds under {root}")
    return system_message, shots


def build_messages(system_message: str, shots, caps: str):
    """OpenAI chat message list: system + few-shot pairs + the query."""
    messages = [{"role": "system", "content": system_message}]
    for shot_caps, shot_conv in shots:
        messages.append({"role": "user", "content": shot_caps.strip()})
        messages.append({"role": "assistant", "content": shot_conv.strip()})
    messages.append({"role": "user", "content": caps.strip()})
    return messages


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--type", required=True, choices=TASK_TYPES)
    parser.add_argument(
        "--caps-file", required=True,
        help='jsonl of {"id", "caps"} records',
    )
    parser.add_argument("--out", required=True)
    parser.add_argument("--seed-dir", default=DEFAULT_SEED_DIR)
    parser.add_argument("--model", default="gpt-4")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument(
        "--query", action="store_true",
        help="send requests live (needs OPENAI_API_KEY + network);"
        " default only writes payload jsonl",
    )
    args = parser.parse_args()

    system_message, shots = load_seeds(args.seed_dir, args.type)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    api_key = os.environ.get("OPENAI_API_KEY")
    if args.query and not api_key:
        raise SystemExit("--query needs OPENAI_API_KEY")

    n = 0
    with open(args.out, "w") as out:
        for line in open(args.caps_file):
            if not line.strip():
                continue
            rec = json.loads(line)
            payload = {
                "model": args.model,
                "temperature": args.temperature,
                "messages": build_messages(
                    system_message, shots, rec["caps"]
                ),
            }
            if args.query:
                import requests

                resp = requests.post(
                    "https://api.openai.com/v1/chat/completions",
                    headers={"Authorization": f"Bearer {api_key}"},
                    json=payload,
                    timeout=120,
                )
                resp.raise_for_status()
                text = resp.json()["choices"][0]["message"]["content"]
                out.write(
                    json.dumps(
                        {"id": rec["id"], "type": args.type, "text": text}
                    )
                    + "\n"
                )
            else:
                out.write(
                    json.dumps({"id": rec["id"], "payload": payload}) + "\n"
                )
            n += 1
    print(f"wrote {n} {'answers' if args.query else 'payloads'} to {args.out}")


if __name__ == "__main__":
    main()
