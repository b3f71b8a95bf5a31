"""COST evaluation/training question banks.

A copy of ``vcoder_tpu/questions.py`` (and its ``data/questions.json``) for
the PyTorch port, which imports nothing of ``vcoder_tpu``; keep the two in
step.

The paraphrase banks are prompt DATA that the published adapters were
trained against — they must match the reference verbatim for eval parity
(reference: vcoder_llava/questions.py:2-104). Stored as a JSON asset
(vcoder_tpu_torch/data/questions.json) and exposed under the reference's names.
"""

from __future__ import annotations

import json
import os

_HERE = os.path.dirname(__file__)

with open(os.path.join(_HERE, "data", "questions.json")) as _f:
    QUESTIONS = json.load(_f)

SEMANTIC_QUESTIONS = QUESTIONS["semantic"]
INSTANCE_QUESTIONS = QUESTIONS["instance"]
PANOPTIC_QUESTIONS = QUESTIONS["panoptic"]
DEPTH_QUESTIONS = QUESTIONS["depth"]

# Paragraph-format instruction suffixes appended when no seg/depth input is
# provided — verbatim (reference: eval/model_seg_loader.py:73,
# eval/model_depth_loader.py:90).
SEG_PARAGRAPH_SUFFIX = (
    " Return the answer in the paragraph format: 'The objects present in"
    " the image are: ...' and then list the objects with their count in"
    " word format (if greater than 1) in front of them, like 'two people'."
)
DEPTH_PARAGRAPH_SUFFIX = (
    ' Return answer in the paragraph format: "The depth order for the'
    ' objects present in the image is: ..." and then list the objects with'
    ' their order number (if greater than 1) separated by a hyphen like'
    ' "person-2". For example, an acceptable response is "The depth order'
    ' for objects present in the image is: bicycle, bicycle-2, bicycle-3,'
    " pavement, road, bus, tree, sky, building.\""
)
