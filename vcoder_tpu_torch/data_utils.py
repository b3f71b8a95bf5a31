"""Synthetic count-QA generation from COST answer strings.

A copy of ``vcoder_tpu/data_utils.py:22-57`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step. For every counted
object in a COST answer it emits a count question and a yes/no
numeric-presence question (reference: vcoder_llava/data_utils.py:119-148);
the stage-3 training mix's 1% extra-count stream uses it
(``train/datasets.py::get_extra_count_data_split``). Noun extraction runs
without synonym canonicalization, as the reference's data_utils does. The
draws come from the module-level ``random`` and ``numpy.random`` streams, as
there, so a caller seeds them.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from vcoder_tpu_torch.eval import nlp
from vcoder_tpu_torch.eval.extraction import obtain_nouns


def generate_qa_pairs(text: str) -> List[Tuple[str, str]]:
    num_nouns = obtain_nouns(text, word_to_com=None)
    qa_pairs: List[Tuple[str, str]] = []

    for obj, count in num_nouns.items():
        plural_obj = nlp.plural(obj) if count == 1 else obj
        count_question = f"How many {plural_obj} are there in the image?"
        count_answer = (
            f"There {'is' if count == 1 else 'are'} "
            f"{nlp.num_to_words(count)} {obj} in the image."
        )
        qa_pairs.append((count_question, count_answer))

        prob_positive = np.random.uniform(0, 1.0)
        if prob_positive > 0.7 or count == 1:
            numeric_presence_question = (
                f"{'Is' if count == 1 else 'Are'} there "
                f"{nlp.num_to_words(count)} {obj} in the image?"
            )
            numeric_presence_answer = "Yes."
        else:
            numbers = [i for i in range(2, count + 6) if i != count]
            cnt = random.choice(numbers)
            numeric_presence_question = (
                f"{'Is' if cnt == 1 else 'Are'} there "
                f"{nlp.num_to_words(cnt)} {obj} in the image?"
            )
            numeric_presence_answer = "No."
        qa_pairs.append((numeric_presence_question, numeric_presence_answer))
        random.shuffle(qa_pairs)

    return random.sample(qa_pairs, min(len(qa_pairs), random.choice([1, 2, 3, 4, 5, 6])))
