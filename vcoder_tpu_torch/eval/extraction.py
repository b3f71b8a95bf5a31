"""Noun/count extraction shared by the COST scorers and QA synthesis.

A copy of ``vcoder_tpu/eval/extraction.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

Mirrors the extraction pipeline of the reference scorer
(reference: vcoder_llava/eval/eval_seg_accuracy.py:24-133) and of
data_utils (reference: vcoder_llava/data_utils.py:14-118) — the only
difference being the deterministic NLP core (eval/nlp.py) in place of
nltk/spacy/inflect/w2n.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from vcoder_tpu_torch.eval import nlp

# Object names with two words (reference: eval_seg_accuracy.py:25-43).
SPECIAL_WORDS = [
    "baseball bat",
    "baseball glove",
    "cell phone",
    "dining table",
    "fire hydrant",
    "french fries",
    "hair drier",
    "hot dog",
    "parking meter",
    "potted plant",
    "soccer ball",
    "soccer player",
    "sports ball",
    "stop sign",
    "teddy bear",
    "tennis racket",
    "toy figure",
    "traffic light",
    "wine glass",
]

_SYNONYMS_PATH = os.path.join(os.path.dirname(__file__), "synonyms.txt")


def load_synonyms(path: str = _SYNONYMS_PATH) -> List[List[str]]:
    with open(path) as f:
        return [line.strip().split(", ") for line in f if line.strip()]


def build_word_to_com(
    include_plurals: bool = True, path: str = _SYNONYMS_PATH
) -> Dict[str, str]:
    """Synonym -> canonical-class map; first entry of each line is canonical
    (reference: eval_seg_accuracy.py:15-21). The seg scorer also maps
    plurals; the depth scorer does not (eval_depth_accuracy.py:10-15)."""
    word_to_com: Dict[str, str] = {}
    for synonym in load_synonyms(path):
        for s in synonym:
            word_to_com[s] = synonym[0]
            if include_plurals:
                word_to_com[nlp.plural(s)] = nlp.plural(synonym[0])
    return word_to_com


def obtain_seg_texts(file_path: str, dedup: bool = True) -> Dict[str, str]:
    """Parse ``<IMG>key<IMG>label`` files; optional wall/window dedup.

    Single canonical implementation — the reference repeats this parser in
    train.py:628-664, vcoder_ds_train.py:300-312, eval_seg_accuracy.py:143
    and eval_depth_accuracy.py:24 (with/without dedup).
    """
    with open(file_path) as f:
        lines = f.readlines()
    labels: Dict[str, str] = {}
    for line in lines:
        if "<IMG>" not in line:
            continue  # blank/trailing lines must not IndexError
        key = line.split("<IMG>")[1].strip("\n")
        label = line.split("<IMG>")[2].strip("\n")
        if dedup:
            label = remove_specific_word(label, "wall")
            label = remove_specific_word(label, "window")
        labels[key] = label
    return labels


def remove_specific_word(text: str, word_to_remove: str) -> str:
    """Keep only the first occurrence of a word, dropping later ones with
    their preceding punctuation (reference: eval_seg_accuracy.py:45-66;
    used to dedup 'wall'/'window' in GT labels)."""
    tokens = re.findall(r"\b\w+\b|[,.]", text)
    result_tokens = []
    word_found = False
    for i, token in enumerate(tokens):
        if token == word_to_remove:
            if not word_found:
                result_tokens.append(token)
                word_found = True
            else:
                if i > 0 and tokens[i - 1] in {",", "."}:
                    result_tokens.pop()
        else:
            result_tokens.append(token)
    result_text = " ".join(result_tokens)
    return re.sub(r"\s([,.](?:\s|$))", r"\1", result_text)


def get_nouns(
    lines: str, word_to_com: Optional[Dict[str, str]] = None
) -> Dict[str, int]:
    """Noun -> occurrence count (reference: eval_seg_accuracy.py:68-112).

    With ``word_to_com`` nouns canonicalize before counting (scorer
    behavior); without, raw nouns count (data_utils behavior,
    data_utils.py:34-78).
    """
    present_words = [s for s in SPECIAL_WORDS if s in lines]
    for w in present_words:
        lines = lines.replace(w, "")

    nouns_list = nlp.tag_nouns(lines)
    if "objects" in nouns_list:
        nouns_list.remove("objects")
    if "image" in nouns_list:
        nouns_list.remove("image")

    noun_dict: Dict[str, int] = {}
    for n in nouns_list:
        if word_to_com is not None and n in word_to_com:
            n = word_to_com[n]
        noun_dict[n] = noun_dict.get(n, 0) + 1

    nouns: Dict[str, int] = {}
    for k, v in noun_dict.items():
        if not (k == "bus" or k == "skis"):
            if v == 1:
                s = nlp.singular_noun(k)
                if s:
                    k = s
            else:
                if not nlp.singular_noun(k):
                    k = nlp.plural(k)
        if not nlp.is_number_word(k):
            if len(k) >= 3:
                if k == "ski":
                    k = "skis"
                elif k == "gras":
                    k = "grass"
                nouns[k] = v
    for w in present_words:
        nouns[w] = 1
    return nouns


def get_num_nouns(lines: str) -> Dict[str, int]:
    """'two people' style chunks -> {noun: count}
    (reference: eval_seg_accuracy.py:114-133)."""
    lines = lines.replace(":", "").replace(".", "")
    num_noun_dict: Dict[str, int] = {}
    for chunk in nlp.extract_num_noun_chunks(lines):
        for n in chunk.split(", "):
            try:
                w = " ".join(n.split(" ")[1:])
                if w == "ski":
                    w = "skis"
                if w:
                    num_noun_dict[w] = nlp.word_to_num(n.split(" ")[0])
            except ValueError:
                pass
    return num_noun_dict


def obtain_nouns(
    text: str, word_to_com: Optional[Dict[str, str]] = None
) -> Dict[str, int]:
    """Merge counted-noun and bare-noun extraction for one text
    (reference: eval_seg_accuracy.py:172-198 one side; data_utils.py:99-118).
    """
    text = text.replace("hair dryer", "hair drier").lower()
    nouns = get_nouns(text, word_to_com)
    num_nouns = get_num_nouns(text)
    for k in [k for k in nouns if nlp.plural(k) in num_nouns]:
        del nouns[k]
    return {**num_nouns, **nouns}
