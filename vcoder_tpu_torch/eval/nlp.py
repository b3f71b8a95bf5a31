"""Self-contained deterministic NLP helpers for the COST scorers.

A copy of ``vcoder_tpu/eval/nlp.py`` for the PyTorch port, which
imports nothing of ``vcoder_tpu``; keep the two in step.

The reference scorers depend on spacy (noun_chunks), nltk (POS tags),
inflect, word2number and num2words (reference:
vcoder_llava/eval/eval_seg_accuracy.py:1-13, data_utils.py:1-12). None of
those ship models/data offline, so this module implements the required
subset deterministically:

* number-word <-> int conversion (``word_to_num`` / ``num_to_words``),
* rule-based pluralize / singularize with the irregulars that occur in
  COCO/COST vocabulary (``plural`` / ``singular_noun`` — inflect protocol:
  ``singular_noun`` returns False for non-plural inputs),
* a lexicon+stoplist noun tagger standing in for nltk's NN/NNP filter
  (COST answers are object lists, where content words are nouns),
* number-noun chunk extraction standing in for spacy noun_chunks-with-NUM.

The count-similarity math downstream is identical to the reference; only
the linguistic tagging is approximated (documented delta).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Numbers
# ---------------------------------------------------------------------------

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_WORD_NUM = {w: i for i, w in enumerate(_UNITS)}
_WORD_NUM.update(_TENS)
_WORD_NUM.update({"a": 1, "an": 1, "hundred": 100})


def word_to_num(text: str) -> int:
    """'two' -> 2, 'twenty five'/'twenty-five' -> 25, '3' -> 3.

    Raises ValueError for non-numbers (mirrors w2n.word_to_num).
    """
    text = text.strip().lower()
    if re.fullmatch(r"\d+", text):
        return int(text)
    words = re.split(r"[\s-]+", text)
    if not words or not all(w in _WORD_NUM for w in words):
        raise ValueError(f"not a number: {text!r}")
    total = 0
    current = 0
    for w in words:
        v = _WORD_NUM[w]
        if w == "hundred":
            current = max(current, 1) * 100
        else:
            current += v
    total += current
    return total


def is_number_word(text: str) -> bool:
    try:
        word_to_num(text)
        return True
    except ValueError:
        return False


def num_to_words(n: int) -> str:
    """1 -> 'one', 25 -> 'twenty-five' (num2words convention)."""
    if n < 0:
        return "minus " + num_to_words(-n)
    if n < 20:
        return _UNITS[n]
    if n < 100:
        tens = {v: k for k, v in _TENS.items()}[n - n % 10]
        return tens if n % 10 == 0 else f"{tens}-{_UNITS[n % 10]}"
    if n < 1000:
        head = f"{_UNITS[n // 100]} hundred"
        return head if n % 100 == 0 else f"{head} {num_to_words(n % 100)}"
    return str(n)


# ---------------------------------------------------------------------------
# Plural / singular (inflect protocol)
# ---------------------------------------------------------------------------

_IRREGULAR_PLURAL = {
    "person": "people", "man": "men", "woman": "women", "child": "children",
    "foot": "feet", "tooth": "teeth", "goose": "geese", "mouse": "mice",
    "sheep": "sheep", "deer": "deer", "fish": "fish", "knife": "knives",
    "leaf": "leaves", "loaf": "loaves", "shelf": "shelves",
    "wolf": "wolves", "scarf": "scarves", "die": "dice", "ox": "oxen",
}
_IRREGULAR_SINGULAR = {v: k for k, v in _IRREGULAR_PLURAL.items()}
# Words that end in 's' (or look plural) but are singular/mass nouns.
_NOT_PLURAL = {
    "bus", "grass", "glass", "class", "dress", "chess", "brass", "moss",
    "cross", "press", "gas", "lens", "tennis", "is", "this", "its",
    "ss", "walrus", "octopus", "cactus", "campus", "asparagus", "hummus",
    "broccoli", "spaghetti", "confetti", "species",
}
_ES_ENDINGS = ("s", "x", "z", "ch", "sh")
_F_TO_VES_KEEP = {"giraffe", "roof", "chef", "chief", "cliff", "belief"}
# Singularization exception tables (inflect gets these right; naive
# suffix rules mangle them — 'ties'->'ty' then the scorer's len>=3
# filter DROPS the noun entirely, so a correct prediction scores 0).
_IES_STRIP_S = {  # stem ends in -ie: strip only the trailing 's'
    "ties", "pies", "lies", "dies", "movies", "cookies", "brownies",
    "smoothies", "selfies", "calories", "zombies", "genies", "goalies",
    "hoodies", "beanies", "birdies", "kiddies", "aunties",
    "collies", "doggies", "magpies", "sorties", "prairies",
}
_VES_TO_FE = {"knives": "knife", "wives": "wife", "lives": "life"}
_VES_TO_F = {
    "wolves": "wolf", "leaves": "leaf", "shelves": "shelf",
    "scarves": "scarf", "loaves": "loaf", "calves": "calf",
    "halves": "half", "thieves": "thief", "hooves": "hoof",
    "elves": "elf", "wharves": "wharf",
}
_OES_STRIP_ES = {
    "potatoes", "tomatoes", "heroes", "echoes", "torpedoes",
    "mosquitoes", "vetoes", "dominoes",
}
_SES_STRIP_ES = {
    "buses", "busses", "gases", "gasses", "walruses", "octopuses",
    "cactuses", "campuses", "viruses", "bonuses", "atlases", "irises",
    "lenses", "geniuses", "censuses",
}


def plural(word: str) -> str:
    """Singular -> plural (inflect.engine().plural)."""
    w = word.lower()
    if " " in w:
        head, _, tail = w.rpartition(" ")
        return f"{head} {plural(tail)}"
    if w in _IRREGULAR_PLURAL:
        return _IRREGULAR_PLURAL[w]
    if w in _IRREGULAR_SINGULAR:  # already plural
        return w
    if w.endswith("y") and len(w) > 1 and w[-2] not in "aeiou":
        return w[:-1] + "ies"
    if w.endswith(("fe",)) and w not in _F_TO_VES_KEEP:
        return w[:-2] + "ves"
    if w.endswith("f") and w not in _F_TO_VES_KEEP and not w.endswith("ff"):
        return w[:-1] + "ves"
    if w.endswith(_ES_ENDINGS):
        return w + "es"
    if w.endswith("o") and w in ("potato", "tomato", "hero", "echo"):
        return w + "es"
    return w + "s"


def singular_noun(word: str):
    """Plural -> singular; False if the word is not plural (inflect
    ``singular_noun`` protocol)."""
    w = word.lower()
    if " " in w:
        head, _, tail = w.rpartition(" ")
        s = singular_noun(tail)
        return f"{head} {s}" if s else False
    if w in _IRREGULAR_SINGULAR:
        return _IRREGULAR_SINGULAR[w]
    if w in _IRREGULAR_PLURAL or w in _NOT_PLURAL:
        return False
    if w.endswith("ies") and len(w) > 3:
        if w in _IES_STRIP_S:
            return w[:-1]  # tie/pie/movie/cookie keep their -ie stem
        return w[:-3] + "y"
    if w.endswith("ves"):
        # Suffix match so compounds resolve too (pocketknives -> knife).
        for tbl in (_VES_TO_FE, _VES_TO_F):
            for k, v in tbl.items():
                if w.endswith(k):
                    return w[: -len(k)] + v
        # gloves/stoves/waves/olives/sleeves: the stem keeps its -ve.
        return w[:-1]
    if w.endswith(("ches", "shes", "xes", "zes", "sses")):
        return w[:-2]
    if w.endswith("oes") and len(w) > 3:
        # shoes->shoe, toes->toe, canoes->canoe; the -o nouns that take
        # -es (potatoes, tomatoes, ...) are enumerated.
        return w[:-2] if w in _OES_STRIP_ES else w[:-1]
    if w.endswith("ss") or not w.endswith("s"):
        return False
    if w in _SES_STRIP_ES:
        return w[:-2]
    if w.endswith("es") and w[:-2].endswith(("x", "z", "ch", "sh")):
        return w[:-2]
    # houses->house, horses->horse, vases->vase, purses->purse: a bare
    # 's' strip — NOT 'es' (that made 'hous'/'hors'/'vas', which the
    # scorer's len>=3 filter then scored as different nouns).
    return w[:-1]


# ---------------------------------------------------------------------------
# Noun tagging (NN/NNP stand-in)
# ---------------------------------------------------------------------------

# Function words / verbs / adjectives common in COST-style answers; anything
# here is NOT a noun. (nltk's perceptron tagger decides from context; COST
# answers are flat object lists, so a stoplist is a faithful stand-in.)
_STOPLIST = {
    "the", "a", "an", "there", "these", "those", "this", "that", "it",
    "its", "they", "them", "their", "i", "you", "we", "he", "she",
    "is", "are", "was", "were", "be", "being", "been", "am",
    "and", "or", "but", "not", "no", "yes",
    "of", "in", "on", "at", "with", "for", "to", "from", "as", "by",
    "near", "behind", "front", "above", "below", "under", "over",
    "present", "visible", "seen", "depicted", "shown", "standing",
    "sitting", "walking", "lying", "wearing", "holding", "located",
    "can", "could", "will", "would", "may", "might", "also", "such",
    "following", "include", "includes", "including", "included",
    "red", "blue", "green", "yellow", "black", "white", "brown", "gray",
    "grey", "orange", "pink", "purple", "large", "small", "big", "little",
    "many", "several", "some", "few", "various", "different", "multiple",
    "other", "another", "same", "left", "right", "top", "bottom", "middle",
}


def tokenize(text: str) -> List[str]:
    return re.findall(r"[a-zA-Z][a-zA-Z'-]*|\d+|[,.:]", text)


def tag_nouns(text: str) -> List[str]:
    """Words judged to be nouns, in order (stand-in for
    ``nltk.pos_tag`` + NN/NNP filter)."""
    nouns = []
    for tok in tokenize(text):
        w = tok.lower()
        if not w[0].isalpha():
            continue
        if w in _STOPLIST or is_number_word(w):
            continue
        nouns.append(w)
    return nouns


def extract_num_noun_chunks(text: str) -> List[str]:
    """Chunks of 'NUM noun...' text, standing in for spacy noun_chunks
    filtered to those containing a NUM token ('a'/'an' chunks are DET,
    not NUM, and are excluded — pinned by tests/test_eval_scorers.py).

    'two wine glasses, a car and three buses' ->
    ['two wine glasses', 'three buses']
    """
    toks = tokenize(text)
    chunks: List[str] = []
    i = 0
    while i < len(toks):
        w = toks[i].lower()
        if w not in ("a", "an") and is_number_word(w):
            j = i + 1
            words = [toks[i]]
            # Multi-word numbers stay inside ONE chunk like a spacy
            # noun_chunk span ('twenty three bottles'); the consumer
            # (extraction.get_num_nouns) then reads split(' ')[0] as the
            # count exactly like the reference (eval_seg_accuracy.py:128)
            # — reference parity, including its single-token-count quirk.
            while (
                j < len(toks)
                and toks[j].lower() not in ("a", "an", "and", "or")
                and is_number_word(toks[j].lower())
            ):
                words.append(toks[j])
                j += 1
            num_end = len(words)
            while j < len(toks):
                nxt = toks[j].lower()
                if (
                    not nxt[0].isalpha()
                    or nxt in ("and", "or")
                    or is_number_word(nxt)
                ):
                    break
                words.append(toks[j])
                j += 1
            if len(words) > num_end:
                chunks.append(" ".join(words))
            i = j
        else:
            i += 1
    return chunks


def comma_noun_chunks(text: str) -> List[str]:
    """Comma-separated noun items (the DS scorer's noun_chunks use-case:
    'bicycle, bicycle-2, pavement' -> each item)."""
    items = []
    for part in re.split(r"[,.]", text):
        part = part.strip()
        part = re.sub(r"^(the|a|an)\s+", "", part, flags=re.I)
        if part and re.search(r"[a-zA-Z]", part):
            items.append(part)
    return items
