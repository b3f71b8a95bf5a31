"""COST CS/HS scorer (count score / hallucination score).

A copy of ``vcoder_tpu/eval/seg_accuracy.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Mirrors the reference scorer's parsing and scoring math exactly
(reference: vcoder_llava/eval/eval_seg_accuracy.py:143-270):

* GT txt files use ``<IMG>key<IMG>label`` lines with 'wall'/'window' dedup.
* Prediction txt files use the ``Image:`` / ``<<QUESTION>>:`` /
  ``<<ANSWER>>:`` record layout the eval loaders write.
* Per image: count-similarity min/max per matched noun; CS = mean
  accuracy, HS = mean over pred-only nouns (1.0 each) AND matched
  nouns' 1 - min/max count mismatch (reference :241-246).

Usage: python -m vcoder_tpu_torch.eval.seg_accuracy --gt_path ... --pred_path ...
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

from vcoder_tpu_torch.eval.extraction import (
    build_word_to_com,
    obtain_nouns,
    obtain_seg_texts,
)

TASKS = ("semantic", "instance", "panoptic")


def extract_conversations(file_path: str) -> Dict[str, str]:
    """Parse loader-emitted prediction txt
    (reference: eval_seg_accuracy.py:157-170)."""
    with open(file_path) as f:
        lines = f.readlines()
    seg_preds: Dict[str, str] = {}
    key = None
    for line in lines:
        if "--------" in line or line.startswith("<<QUESTION>>"):
            continue
        elif line.startswith("Image: "):
            key = line.split("Image: ")[1].strip("\n")
            seg_preds[key] = ""
        elif key is not None:
            seg_preds[key] = (
                line.strip("<<ANSWER>>: ").strip("\n").split("</s>")[0]
            )
    return seg_preds


def score_pair(
    gt: str, pred: str, word_to_com: Dict[str, str]
) -> Tuple[float, float, Dict[str, int], Dict[str, int]]:
    """(accuracy, hallucination) for one image
    (reference: eval_seg_accuracy.py:228-250)."""
    num_nouns_gt = obtain_nouns(gt, word_to_com)
    num_nouns_pred = obtain_nouns(pred, word_to_com)

    acc_scores: List[float] = []
    for k in num_nouns_gt:
        if k in num_nouns_pred:
            acc_scores.append(
                min(num_nouns_gt[k], num_nouns_pred[k])
                / max(num_nouns_gt[k], num_nouns_pred[k])
            )
        else:
            acc_scores.append(0.0)

    hall_scores: List[float] = []
    for k in num_nouns_pred:
        if k in num_nouns_gt:
            score = min(num_nouns_gt[k], num_nouns_pred[k]) / max(
                num_nouns_gt[k], num_nouns_pred[k]
            )
            hall_scores.append(1.0 - score)
        else:
            hall_scores.append(1.0)

    acc = sum(acc_scores) / len(acc_scores) if acc_scores else None
    hall = sum(hall_scores) / len(hall_scores) if hall_scores else None
    return acc, hall, num_nouns_gt, num_nouns_pred


def calculate_accuracy_hallucination(
    gt_dir: str, pred_dir: str, tasks=TASKS, write_json: bool = True
):
    word_to_com = build_word_to_com(include_plurals=True)
    acc_avg_scores: Dict[str, List[float]] = {}
    hallucination_avg_scores: Dict[str, List[float]] = {}
    json_pred: Dict[str, dict] = {}
    json_gt: Dict[str, dict] = {}
    for task in tasks:
        print(f"Evaluating for {task} segmentation...")
        json_pred[task] = {}
        json_gt[task] = {}
        gt_labels = obtain_seg_texts(os.path.join(gt_dir, task + ".txt"))
        preds = extract_conversations(
            os.path.join(pred_dir, "output_" + task + ".txt")
        )
        assert all(k in gt_labels for k in preds), (
            "GT and Predicted files don't match!"
        )
        acc_avg_scores[task] = []
        hallucination_avg_scores[task] = []
        for k in gt_labels:
            if k not in preds:
                continue
            acc, hall, n_gt, n_pred = score_pair(
                gt_labels[k], preds[k], word_to_com
            )
            json_gt[task][k] = n_gt
            json_pred[task][k] = n_pred
            if acc is not None:
                acc_avg_scores[task].append(acc)
            if hall is not None:
                hallucination_avg_scores[task].append(hall)

    if write_json:
        with open(os.path.join(gt_dir, "gt.json"), "w") as f:
            json.dump(json_gt, f)
        with open(os.path.join(pred_dir, "pred.json"), "w") as f:
            json.dump(json_pred, f)
    return acc_avg_scores, hallucination_avg_scores


def main():
    parser = argparse.ArgumentParser(description="COST CS/HS scorer")
    parser.add_argument("--gt_path", type=str, required=True)
    parser.add_argument("--pred_path", type=str, required=True)
    parser.add_argument(
        "--tasks", type=str, default=",".join(TASKS),
        help="comma-separated subset of semantic,instance,panoptic",
    )
    args = parser.parse_args()

    acc, hall = calculate_accuracy_hallucination(
        args.gt_path, args.pred_path,
        tasks=tuple(t.strip() for t in args.tasks.split(",") if t.strip()),
    )
    def _avg(xs):
        # Guard empty lists (all-empty predictions) like the depth
        # scorer's nan fallback; non-empty output matches the reference
        # byte-for-byte (eval_seg_accuracy.py:269-270).
        return round((sum(xs) / len(xs)) * 100, 1) if xs else float("nan")

    for k, v in acc.items():
        print(
            "Average accuracy for {} segmentation is: {}".format(
                k, _avg(v)
            )
        )
        print(
            "Average hallucination for {} segmentation is: {}".format(
                k, _avg(hall[k])
            )
        )


if __name__ == "__main__":
    main()
