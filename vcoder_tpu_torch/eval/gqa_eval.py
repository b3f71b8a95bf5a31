"""GQA official-metric scorer.

A copy of ``vcoder_tpu/eval/gqa_eval.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Implements the metric suite of the official GQA evaluation script the
reference vendors (reference: playground/data/eval/gqa/data/eval/eval.py,
468 LoC): balanced accuracy, binary/open split, validity and plausibility
(from the choices file, including the "Common" detailed-type
normalization), consistency over entailed questions, distribution
(chi-square over global answer groups), and accuracy per
structural/semantic type, word count, and reasoning-step count.

Grounding (attention-map overlap) is intentionally not implemented: it
only applies to models that expose spatial/object attention maps, which
this framework's generation API does not surface (the reference never
invokes it either — scripts/v1_5/eval/gqa.sh runs eval.py without
--grounding).

Usage (mirrors scripts/v1_5/eval/gqa.sh):
    python -m vcoder_tpu_torch.eval.gqa_eval \
        --questions testdev_balanced_questions.json \
        --predictions testdev_balanced_predictions.json \
        [--choices testdev_balanced_choices.json] [--consistency]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict


def load_file(name: str):
    """Official loadFile: a plain json file, or a directory of
    ``<dir>/<dir>_*.<ext>`` chunks merged into one dict (eval.py:103-117)."""
    if os.path.isfile(name):
        with open(name) as f:
            return json.load(f)
    stem, ext = name.rsplit(".", 1)
    if os.path.isdir(stem):
        data = {}
        for chunk in sorted(
            glob.glob(os.path.join(stem, f"{os.path.basename(stem)}_*.{ext}"))
        ):
            with open(chunk) as f:
                data.update(json.load(f))
        return data
    raise FileNotFoundError(name)


def _avg(xs):
    return float(sum(xs)) / len(xs) if xs else 0.0


def _words_num(question: dict) -> int:
    return len(question["question"].split())


def _steps_num(question: dict) -> int:
    """Reasoning steps, excluding final querying ops (eval.py:207-209)."""
    return len(
        [
            c
            for c in question.get("semantic", [])
            if not any(
                o in "{}: {}".format(c["operation"], c["argument"])
                for o in ["exist", "query: name", "choose name"]
            )
        ]
    )


def _belongs(element: str, group, question: dict) -> bool:
    """Official belongs(): questions of a "Common" detailed type accept the
    attribute-category names themselves (eval.py:232-237)."""
    if "Common" in question["types"]["detailed"]:
        group = ["color", "material", "shape"]
    return element in group


def _chi_square(gold_dist, predicted_dist) -> float:
    """Per-group chi-square of predicted vs gold answer histograms,
    weighted by group size (eval.py:329-347)."""
    sum_score, sum_overall = 0.0, 0
    for group in gold_dist:
        score, overall = 0.0, 0
        for ans, e in gold_dist[group].items():
            o = predicted_dist[group].get(ans, 0)
            score += float(o - e) ** 2 / e
            overall += e
        sum_score += score * overall
        sum_overall += overall
    if sum_overall == 0:
        return 0.0
    return sum_score / sum_overall


def evaluate(
    questions: dict,
    predictions: dict,
    choices: dict | None = None,
    consistency: bool = False,
) -> dict:
    """Score predictions against a GQA questions dict.

    Returns the official metrics as percentages (distribution as the raw
    chi-square / 100, lower is better), plus detailed per-type tables as
    ``{key: (score_pct, n_questions)}``.
    """
    # Official completeness gate (eval.py:143-147): every balanced question
    # needs a prediction; with --consistency, every question does (entailed
    # questions live outside the balanced subset).
    for qid, q in questions.items():
        if qid not in predictions and (consistency or q.get("isBalanced")):
            raise ValueError(f"no prediction for question {qid}")

    scores = {
        "accuracy": [],
        "binary": [],
        "open": [],
        "validity": [],
        "plausibility": [],
        "consistency": [],
    }
    detailed = {
        "accuracyPerStructuralType": defaultdict(list),
        "accuracyPerSemanticType": defaultdict(list),
        "accuracyPerLength": defaultdict(list),
        "accuracyPerSteps": defaultdict(list),
    }
    dist_gold = defaultdict(lambda: defaultdict(int))
    dist_pred = defaultdict(lambda: defaultdict(int))

    for qid, question in questions.items():
        if not question.get("isBalanced"):
            continue
        gold = question["answer"]
        predicted = predictions[qid]
        correct = predicted == gold
        score = float(correct)

        scores["accuracy"].append(score)
        detailed["accuracyPerLength"][_words_num(question)].append(score)
        detailed["accuracyPerSteps"][_steps_num(question)].append(score)
        detailed["accuracyPerStructuralType"][
            question["types"]["structural"]
        ].append(score)
        detailed["accuracyPerSemanticType"][
            question["types"]["semantic"]
        ].append(score)
        answer_type = (
            "open" if question["types"]["structural"] == "query" else "binary"
        )
        scores[answer_type].append(score)

        if choices is not None:
            scores["validity"].append(
                float(_belongs(predicted, choices[qid]["valid"], question))
            )
            scores["plausibility"].append(
                float(
                    _belongs(predicted, choices[qid]["plausible"], question)
                )
            )

        global_group = question.get("groups", {}).get("global")
        if global_group is not None:
            dist_gold[global_group][gold] += 1
            dist_pred[global_group][predicted] += 1

        if consistency and correct:
            inferred = [e for e in question.get("entailed", []) if e != qid]
            if inferred:
                scores["consistency"].append(
                    _avg(
                        [
                            float(
                                predictions[e] == questions[e]["answer"]
                            )
                            for e in inferred
                        ]
                    )
                )

    out = {
        k: round(_avg(v) * 100.0, 2)
        for k, v in scores.items()
        if not (k == "consistency" and not consistency)
        and not (k in ("validity", "plausibility") and choices is None)
    }
    out["distribution"] = round(_chi_square(dist_gold, dist_pred) / 100.0, 2)
    for key, table in detailed.items():
        out[key] = {
            t: (round(_avg(v) * 100.0, 2), len(v)) for t, v in table.items()
        }
    out["n"] = len(scores["accuracy"])
    return out


_DETAILED_TITLES = [
    ("accuracyPerStructuralType", "Accuracy / structural type"),
    ("accuracyPerSemanticType", "Accuracy / semantic type"),
    ("accuracyPerSteps", "Accuracy / steps number"),
    ("accuracyPerLength", "Accuracy / words number"),
]

_SUB_METRICS = {
    "attr": "attribute",
    "cat": "category",
    "global": "scene",
    "obj": "object",
    "rel": "relation",
}


def print_scores(out: dict, consistency: bool = False) -> None:
    """Official-format report (eval.py:432-467)."""
    order = [
        "binary",
        "open",
        "accuracy",
        "consistency",
        "validity",
        "plausibility",
        "distribution",
    ]
    print("")
    for m in order:
        if m not in out:
            continue
        suffix = " (lower is better)" if m == "distribution" else "%"
        print(f"{m.capitalize()}: {out[m]:.2f}{suffix}")
    for key, title in _DETAILED_TITLES:
        print(f"\n{title}:")
        for t in sorted(out[key]):
            name = _SUB_METRICS.get(t, t)
            name = name.capitalize() if isinstance(name, str) else name
            score, n = out[key][t]
            print(f"  {name}: {score:.2f}% ({n} questions)")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--questions", type=str, required=True)
    parser.add_argument(
        "--predictions", type=str, required=True,
        help="json list of {questionId, prediction} (converters gqa output)",
    )
    parser.add_argument(
        "--choices", type=str, default=None,
        help="GQA choices file for validity/plausibility",
    )
    parser.add_argument(
        "--consistency", action="store_true",
        help="score entailed-question consistency (needs predictions for"
        " ALL questions, e.g. val_all_questions.json)",
    )
    args = parser.parse_args()

    questions = load_file(args.questions)
    preds_raw = load_file(args.predictions)
    predictions = {str(p["questionId"]): p["prediction"] for p in preds_raw}
    choices = load_file(args.choices) if args.choices else None
    out = evaluate(
        questions, predictions, choices=choices, consistency=args.consistency
    )
    print_scores(out, consistency=args.consistency)
    print("\n" + json.dumps({k: v for k, v in out.items()}))


if __name__ == "__main__":
    main()
