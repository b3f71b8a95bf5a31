"""POPE yes/no hallucination benchmark scorer.

A copy of ``vcoder_tpu/eval/pope.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Mirrors the reference exactly (reference: vcoder_llava/eval/eval_pope.py):
first-sentence yes/no normalization, TP/FP/TN/FN and
acc/precision/recall/F1/yes-ratio per annotation category.

Usage: python -m vcoder_tpu_torch.eval.pope --annotation-dir d \
          --question-file q.jsonl --result-file a.jsonl
"""

from __future__ import annotations

import argparse
import json
import os


def eval_pope(answers, label_file):
    label_list = [json.loads(q)["label"] for q in open(label_file, "r")]

    for answer in answers:
        text = answer["text"]
        # Only keep the first sentence
        if text.find(".") != -1:
            text = text.split(".")[0]
        text = text.replace(",", "")
        words = text.split(" ")
        if "No" in words or "not" in words or "no" in words:
            answer["text"] = "no"
        else:
            answer["text"] = "yes"

    label_list = [0 if l == "no" else 1 for l in label_list]
    pred_list = [0 if a["text"] == "no" else 1 for a in answers]

    pos, neg = 1, 0
    yes_ratio = pred_list.count(1) / len(pred_list)

    TP = TN = FP = FN = 0
    for pred, label in zip(pred_list, label_list):
        if pred == pos and label == pos:
            TP += 1
        elif pred == pos and label == neg:
            FP += 1
        elif pred == neg and label == neg:
            TN += 1
        elif pred == neg and label == pos:
            FN += 1

    print("TP\tFP\tTN\tFN\t")
    print(f"{TP}\t{FP}\t{TN}\t{FN}")

    precision = float(TP) / float(TP + FP) if TP + FP else 0.0
    recall = float(TP) / float(TP + FN) if TP + FN else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    acc = (TP + TN) / (TP + TN + FP + FN)
    print("Accuracy: {}".format(acc))
    print("Precision: {}".format(precision))
    print("Recall: {}".format(recall))
    print("F1 score: {}".format(f1))
    print("Yes ratio: {}".format(yes_ratio))
    print(
        "%.3f, %.3f, %.3f, %.3f, %.3f"
        % (f1, acc, precision, recall, yes_ratio)
    )
    return dict(
        f1=f1, acc=acc, precision=precision, recall=recall,
        yes_ratio=yes_ratio,
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-dir", type=str, required=True)
    parser.add_argument("--question-file", type=str, required=True)
    parser.add_argument("--result-file", type=str, required=True)
    args = parser.parse_args()

    questions = {
        q["question_id"]: q
        for q in (json.loads(line) for line in open(args.question_file))
    }
    answers = [json.loads(q) for q in open(args.result_file)]
    for file in os.listdir(args.annotation_dir):
        assert file.startswith("coco_pope_")
        assert file.endswith(".json")
        category = file[10:-5]
        cur_answers = [
            x
            for x in answers
            if questions[x["question_id"]]["category"] == category
        ]
        print(
            "Category: {}, # samples: {}".format(category, len(cur_answers))
        )
        eval_pope(cur_answers, os.path.join(args.annotation_dir, file))
        print("====================================")


if __name__ == "__main__":
    main()
