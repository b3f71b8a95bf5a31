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
"""

__version__ = "0.1.0"
