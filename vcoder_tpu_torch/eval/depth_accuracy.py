"""COST depth-order (DS) scorer.

A copy of ``vcoder_tpu/eval/depth_accuracy.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Mirrors the reference DS metric (reference:
vcoder_llava/eval/eval_depth_accuracy.py:49-112): parse per-object
positions from "The depth order ... : a, b-2, c" answers, pad missing
occurrences with 100, DS = mean |gt_pos - pred_pos| / num_gt_objects.
Lower is better.

Usage: python -m vcoder_tpu_torch.eval.depth_accuracy --gt_path g.txt --pred_path p.txt
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

from vcoder_tpu_torch.eval import nlp
from vcoder_tpu_torch.eval.extraction import build_word_to_com, obtain_seg_texts
from vcoder_tpu_torch.eval.seg_accuracy import extract_conversations

# Depth scorer canonicalizes WITHOUT plural entries
# (reference: eval_depth_accuracy.py:10-15).
_WORD_TO_COM = None


def _word_to_com() -> Dict[str, str]:
    global _WORD_TO_COM
    if _WORD_TO_COM is None:
        _WORD_TO_COM = build_word_to_com(include_plurals=False)
    return _WORD_TO_COM


def obtain_depth_texts(file_path: str) -> Dict[str, str]:
    """GT parse without the wall/window dedup
    (reference: eval_depth_accuracy.py:24-33)."""
    return obtain_seg_texts(file_path, dedup=False)


def get_order(lines: str) -> Tuple[Dict[str, List[int]], int]:
    """Object -> [positions] from the colon-tail list
    (reference: eval_depth_accuracy.py:49-66)."""
    if len(lines.split(":")) == 1:
        return {}, 0
    lines = lines.split(":")[1]
    word_to_com = _word_to_com()
    positions: Dict[str, List[int]] = {}
    order_num = 1
    for noun in nlp.comma_noun_chunks(lines):
        obj = noun.split("-")[0].strip()
        obj = word_to_com.get(obj, obj)
        positions.setdefault(obj, []).append(order_num)
        order_num += 1
    return positions, order_num - 1


def score_pair(gt: str, pred: str):
    gt = gt.replace("hair dryer", "hair drier").lower()
    pred = pred.replace("hair dryer", "hair drier").lower()
    position_gt, order_num = get_order(gt)
    position_pred, _ = get_order(pred)

    depth_distance: List[float] = []
    for k in position_gt:
        if k in position_pred:
            order_pred = list(position_pred[k])
            order_gt = list(position_gt[k])
            if len(order_gt) < len(order_pred):
                order_gt.extend([100] * (len(order_pred) - len(order_gt)))
            elif len(order_pred) < len(order_gt):
                order_pred.extend([100] * (len(order_gt) - len(order_pred)))
            for i, j in zip(order_gt, order_pred):
                if i == 100 and j == 100:
                    continue
                depth_distance.append(abs(i - j))
        else:
            depth_distance.append(100)
    if depth_distance and order_num > 0:
        return sum(depth_distance) / order_num
    return None


def calculate_depth_score(gt_path: str, pred_path: str) -> List[float]:
    gt_labels = obtain_depth_texts(gt_path)
    preds = extract_conversations(pred_path)
    assert all(k in gt_labels for k in preds), (
        "GT and Predicted files don't match!"
    )
    scores = []
    for k in gt_labels:
        if k not in preds:
            continue
        s = score_pair(gt_labels[k], preds[k])
        if s is not None:
            scores.append(s)
    return scores


def main():
    parser = argparse.ArgumentParser(description="COST DS scorer")
    parser.add_argument("--gt_path", type=str, required=True)
    parser.add_argument("--pred_path", type=str, required=True)
    args = parser.parse_args()
    scores = calculate_depth_score(args.gt_path, args.pred_path)
    print(
        "Average depth score is: {}".format(
            # round(..., 2) matches the reference printout exactly
            # (eval_depth_accuracy.py:119) for blind parity diffs.
            round(sum(scores) / len(scores), 2) if scores else float("nan")
        )
    )


if __name__ == "__main__":
    main()
