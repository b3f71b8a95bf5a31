"""MME scorer over the converter's per-category txt files.

A copy of ``vcoder_tpu/eval/mme_eval.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

The reference's MME pipeline ends at external tooling: model answers ->
``convert_answer_to_mme.py`` -> the MME release's ``eval_tool/
calculation.py`` (reference: scripts/v1_5/eval/mme.sh:12-16 — neither
tool is vendored there). This module implements the eval_tool's scoring
semantics so the pipeline is self-contained and the converter's output
format (``img\\tquestion\\tgt\\tpred`` lines per category, written by
eval/converters.py::convert_mme) is validated end-to-end:

* predictions normalize to yes/no/other (leading "yes"/"no" match),
* acc        = correct answers / all questions,
* acc+       = images with BOTH of their two questions correct / images,
* category score = 100 * (acc + acc+)  (max 200),
* perception = sum of the 10 perception category scores (max 2000),
  cognition  = sum of the 4 cognition category scores (max 800).

Usage:
    python -m vcoder_tpu_torch.eval.mme_eval --results_dir answers/<experiment>
"""

from __future__ import annotations

import argparse
import glob
import os
from collections import defaultdict

PERCEPTION = (
    "existence",
    "count",
    "position",
    "color",
    "posters",
    "celebrity",
    "scene",
    "landmark",
    "artwork",
    "OCR",
)
COGNITION = (
    "commonsense_reasoning",
    "numerical_calculation",
    "text_translation",
    "code_reasoning",
)


def parse_pred(text: str) -> str:
    """Normalize a free-form answer to yes/no/other — the eval_tool's
    EXACT rule (calculation.py parse_pred_ans): exact match, else
    substring match of 'yes'/'no' within the first 4 characters. That
    rule scores 'Nothing'/'Not sure' as 'no'; published MME numbers
    depend on it, so the quirk is reproduced, not sanitized."""
    t = text.strip().lower()
    if t in ("yes", "no"):
        return t
    prefix = t[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def score_category(path: str) -> dict:
    """Score one category txt: lines of img\\tquestion\\tgt\\tpred."""
    per_image = defaultdict(list)
    n, n_correct = 0, 0
    for line in open(path):
        line = line.rstrip("\n")
        if not line:
            continue
        img, _question, gt, pred = line.split("\t")
        correct = parse_pred(pred) == gt.strip().lower()
        per_image[img].append(correct)
        n += 1
        n_correct += int(correct)
    acc = n_correct / n if n else 0.0
    both = sum(1 for v in per_image.values() if len(v) >= 2 and all(v))
    acc_plus = both / len(per_image) if per_image else 0.0
    return {
        "acc": acc,
        "acc_plus": acc_plus,
        "score": 100.0 * (acc + acc_plus),
        "n": n,
    }


def evaluate_dir(results_dir: str) -> dict:
    out = {"categories": {}, "perception": 0.0, "cognition": 0.0}
    for path in sorted(glob.glob(os.path.join(results_dir, "*.txt"))):
        cat = os.path.splitext(os.path.basename(path))[0]
        s = score_category(path)
        out["categories"][cat] = s
        if cat in PERCEPTION:
            out["perception"] += s["score"]
        elif cat in COGNITION:
            out["cognition"] += s["score"]
        else:
            import logging

            logging.getLogger("vcoder_tpu_torch").warning(
                "mme_eval: category %r is neither perception nor "
                "cognition — excluded from both totals (check the "
                "category casing in the question file)", cat,
            )
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--results_dir", required=True,
        help="directory of per-category txt files (converters mme output)",
    )
    args = parser.parse_args()
    out = evaluate_dir(args.results_dir)
    for cat, s in out["categories"].items():
        print(
            f"{cat}: score {s['score']:.2f} "
            f"(acc {100 * s['acc']:.2f}%, acc+ {100 * s['acc_plus']:.2f}%,"
            f" {s['n']} questions)"
        )
    print(f"perception total: {out['perception']:.2f} / 2000")
    print(f"cognition total: {out['cognition']:.2f} / 800")


if __name__ == "__main__":
    main()
