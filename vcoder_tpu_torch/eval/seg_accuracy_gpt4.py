"""CS/HS scorer variant for GPT-4V outputs.

A copy of ``vcoder_tpu/eval/seg_accuracy_gpt4.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Mirrors the reference variant (reference:
vcoder_llava/eval/eval_seg_accuracy_gpt4.py): instead of the full COCO
synonym canonicalization it folds only person-words to person/persons
(WORD_TO_COM, :14-27), since GPT-4V answers use freeform vocabulary.

Usage: python -m vcoder_tpu_torch.eval.seg_accuracy_gpt4 --gt_path g --pred_path p
"""

from __future__ import annotations

import argparse
import os

from vcoder_tpu_torch.eval.seg_accuracy import (
    extract_conversations,
    obtain_seg_texts,
    score_pair,
)

# Person-synonym folding (reference: eval_seg_accuracy_gpt4.py:14-27).
WORD_TO_COM = {
    "man": "person",
    "woman": "person",
    "child": "person",
    "children": "persons",
    "men": "persons",
    "women": "persons",
    "kid": "person",
    "kids": "persons",
    "girl": "person",
    "boy": "person",
    "girls": "persons",
    "boys": "persons",
}


def calculate_accuracy_hallucination(gt_dir: str, pred_dir: str):
    acc_avg, hall_avg = {}, {}
    for task in ("semantic", "instance", "panoptic"):
        gt_file = os.path.join(gt_dir, task + ".txt")
        pred_file = os.path.join(pred_dir, "output_" + task + ".txt")
        if not (os.path.exists(gt_file) and os.path.exists(pred_file)):
            continue
        gt_labels = obtain_seg_texts(gt_file)
        preds = extract_conversations(pred_file)
        acc_avg[task] = []
        hall_avg[task] = []
        for k in gt_labels:
            if k not in preds:
                continue
            acc, hall, _, _ = score_pair(
                gt_labels[k], preds[k], WORD_TO_COM
            )
            if acc is not None:
                acc_avg[task].append(acc)
            if hall is not None:
                hall_avg[task].append(hall)
    return acc_avg, hall_avg


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt_path", type=str, required=True)
    parser.add_argument("--pred_path", type=str, required=True)
    args = parser.parse_args()
    acc, hall = calculate_accuracy_hallucination(args.gt_path, args.pred_path)
    for k, v in acc.items():
        print(
            "Average accuracy for {} segmentation is: {}".format(
                k, round((sum(v) / len(v)) * 100, 1)
            )
        )
        print(
            "Average hallucination for {} segmentation is: {}".format(
                k, round((sum(hall[k]) / len(hall[k])) * 100, 1)
            )
        )


if __name__ == "__main__":
    main()
