"""TextVQA / ST-VQA / TextCaps metric evaluators.

A copy of ``vcoder_tpu/eval/m4c_evaluator.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Reimplements the reference's EvalAI-compatible metrics (reference:
vcoder_llava/eval/m4c_evaluator.py, itself derived from the public
facebookresearch/mmf processors). The normalization tables (contractions,
number map, articles, punctuation) are metric DATA loaded from
``data_evalai.json`` for exact parity.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

_HERE = os.path.dirname(__file__)
with open(os.path.join(_HERE, "data_evalai.json")) as _f:
    _T = json.load(_f)


class EvalAIAnswerProcessor:
    """EvalAI answer normalization: tokenize, strip punctuation, map number
    words, drop articles, expand contractions."""

    CONTRACTIONS: Dict[str, str] = _T["contractions"]
    NUMBER_MAP: Dict[str, str] = _T["number_map"]
    ARTICLES: List[str] = _T["articles"]
    PUNCTUATIONS: List[str] = _T["punctuations"]
    COMMA_STRIP = re.compile(_T["comma_strip"])
    PERIOD_STRIP = re.compile(_T["period_strip"])

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, in_text: str) -> str:
        out_text = in_text
        for p in self.PUNCTUATIONS:
            if (p + " " in in_text or " " + p in in_text) or (
                re.search(self.COMMA_STRIP, in_text) is not None
            ):
                out_text = out_text.replace(p, "")
            else:
                out_text = out_text.replace(p, " ")
        out_text = self.PERIOD_STRIP.sub("", out_text, re.UNICODE)
        return out_text

    def process_digit_article(self, in_text: str) -> str:
        out_text = []
        for word in in_text.lower().split():
            word = self.NUMBER_MAP.setdefault(word, word)
            if word not in self.ARTICLES:
                out_text.append(word)
        for i, word in enumerate(out_text):
            if word in self.CONTRACTIONS:
                out_text[i] = self.CONTRACTIONS[word]
        return " ".join(out_text)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


class TextVQAAccuracyEvaluator:
    """VQA soft accuracy: min(1, matches/3) averaged leave-one-out over the
    10 human answers."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def _compute_answer_scores(self, raw_answers):
        answers = [self.answer_processor(a) for a in raw_answers]
        assert len(answers) == 10
        gt_answers = list(enumerate(answers))
        unique_answer_scores = {}
        for unique_answer in set(answers):
            accs = []
            for gt_answer in gt_answers:
                other = [a for a in gt_answers if a != gt_answer]
                matching = [a for a in other if a[1] == unique_answer]
                accs.append(min(1, float(len(matching)) / 3))
            unique_answer_scores[unique_answer] = sum(accs) / len(accs)
        return unique_answer_scores

    def eval_pred_list(self, pred_list):
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            scores = self._compute_answer_scores(entry["gt_answers"])
            pred_scores.append(scores.get(pred_answer, 0.0))
        return sum(pred_scores) / len(pred_scores)


class STVQAAccuracyEvaluator:
    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list):
        pred_scores = []
        for entry in pred_list:
            pred = self.answer_processor(entry["pred_answer"])
            gts = [self.answer_processor(a) for a in entry["gt_answers"]]
            pred_scores.append(1.0 if pred in gts else 0.0)
        return sum(pred_scores) / len(pred_scores)


def _edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (replaces the editdistance dependency)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(
                min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            )
        prev = cur
    return prev[-1]


class STVQAANLSEvaluator:
    def get_anls(self, s1: str, s2: str) -> float:
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        iou = 1 - _edit_distance(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    def eval_pred_list(self, pred_list):
        pred_scores = [
            max(
                self.get_anls(e["pred_answer"], gt)
                for gt in e["gt_answers"]
            )
            for e in pred_list
        ]
        return sum(pred_scores) / len(pred_scores)


class TextCapsBleu4Evaluator:
    """BLEU-4 over caption predictions (pure-Python BLEU; the reference
    shells out to pycocoevalcap/Java)."""

    def eval_pred_list(self, pred_list):
        import collections
        import math

        def ngrams(tokens, n):
            return collections.Counter(
                tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
            )

        log_precisions = []
        for n in range(1, 5):
            match, total = 0, 0
            for entry in pred_list:
                hyp = entry["pred_answer"].lower().split()
                refs = [a.lower().split() for a in entry["gt_answers"]]
                hyp_ng = ngrams(hyp, n)
                max_ref = collections.Counter()
                for r in refs:
                    for g, c in ngrams(r, n).items():
                        max_ref[g] = max(max_ref[g], c)
                match += sum(
                    min(c, max_ref.get(g, 0)) for g, c in hyp_ng.items()
                )
                total += max(sum(hyp_ng.values()), 1)
            log_precisions.append(
                math.log(match / total) if match > 0 else -1e9
            )
        hyp_len = sum(
            len(e["pred_answer"].split()) for e in pred_list
        )
        ref_len = sum(
            min(
                (len(a.split()) for a in e["gt_answers"]),
                key=lambda L: (
                    abs(L - len(e["pred_answer"].split())), L
                ),
            )
            for e in pred_list
        )
        import math

        bp = (
            1.0
            if hyp_len > ref_len
            else math.exp(1 - ref_len / max(hyp_len, 1))
        )
        return bp * math.exp(sum(log_precisions) / 4)
