"""Model-wide constants.

Mirrors the sentinel-token contract of the reference implementation
(reference: vcoder_llava/constants.py:1-12): negative out-of-vocab ids mark
positions in the token stream where encoded vision features are spliced in.

A copy of ``vcoder_tpu/constants.py`` for the PyTorch port, which imports nothing
of ``vcoder_tpu``; keep the two in step.
"""

LOGDIR = "."

IGNORE_INDEX = -100

IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"

SEG_TOKEN_INDEX = -300
DEFAULT_SEG_TOKEN = "<seg>"

DEPTH_TOKEN_INDEX = -400
DEFAULT_DEPTH_TOKEN = "<depth>"

# Number of vision tokens contributed per modality occurrence:
# CLIP ViT-L/14 @ 336px -> (336/14)^2 = 576 patch tokens (CLS dropped).
# (reference: vcoder_llava/model/multimodal_encoder/clip_encoder.py:76-78)
NUM_PATCH_TOKENS = 576
