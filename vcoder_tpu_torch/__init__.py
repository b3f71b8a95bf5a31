"""PyTorch/CUDA port of ``vcoder_tpu`` for one NVIDIA H100.

The JAX package ``vcoder_tpu`` is the reference; this package imports nothing
of it (the host-side modules it needs are copied) and mirrors its module
layout, so each module here has its counterpart at the same path there.
The TPU's Pallas kernels on the serving path (attention, paged attention,
the int4 and int8 quantized matmuls) are hand-written CUDA kernels for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use.

Entry points (``builder.load_pretrained_model``, ``generation.generate``,
``models.vcoder.init_vcoder_params``, ``serve.paged_engine.PagedServingEngine``)
run on CUDA unless the caller passes ``device="cpu"``, and raise when CUDA is
absent.

The public names are the JAX package's (``vcoder_tpu/__init__.py:45-72``):
the sentinel constants, the ``mm_tokens`` helpers, and
``load_pretrained_model`` / ``process_images``, which import their modules
at the first call. (The JAX package's compile-cache and platform switches
have no counterpart.)
"""

__version__ = "0.1.0"

from vcoder_tpu_torch.constants import (  # noqa: F401
    DEFAULT_DEPTH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_SEG_TOKEN,
    DEPTH_TOKEN_INDEX,
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    SEG_TOKEN_INDEX,
)
from vcoder_tpu_torch.mm_tokens import (  # noqa: F401
    KeywordsStoppingCriteria,
    get_model_name_from_path,
    tokenizer_depth_seg_token,
    tokenizer_image_token,
    tokenizer_seg_token,
)


def load_pretrained_model(*args, **kwargs):
    from vcoder_tpu_torch.builder import load_pretrained_model as _f

    return _f(*args, **kwargs)


def process_images(*args, **kwargs):
    from vcoder_tpu_torch.preprocess import process_images as _f

    return _f(*args, **kwargs)
