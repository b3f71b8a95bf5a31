#!/usr/bin/env python3
"""Engine A (bf16 weights) and engine D (int4 weights) decode-step walls and
the int4 B=1 decode rate of one checkout on one GPU, for a same-card A/B of
two checkouts run in turns.

    python3 scripts/int4_serving_ab.py [ROOT]     # ROOT: a checkout (default: this one)
    for r in OLD . . OLD; do python3 scripts/int4_serving_ab.py $r; done

It imports ``chip_smoke`` and the port from ROOT and runs what phase 7 of
``chip_smoke.py`` runs for them: VCoder-DS-7B with seeded random bf16
weights, quantized on the card to int4; engines A and D (bf16 pools,
``max_batch`` 8) serve engine A's 8 requests of 32 tokens twice, the second
turn read (per-step wall p50 of the decode steps, host clock); then the 3
B=1 requests of phase 4 through ``generate`` on the int4 model (decode
tok/s p50, host clock). Engine A runs no int4 product: its wall shows how
fast the host ran in that process.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int4_serving_ab: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.builder import VCoderForCausalLM
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.ops import _kernels
    from vcoder_tpu_torch.quant import quantize_params

    cs.log(f"checkout {ROOT}")
    cs.phase_device()
    _kernels.build(["flash_fwd", "gemm_bias", "vit_mlp", "paged_attn", "int4_matmul", "int8_mm"])
    cfg, params, _, tok = cs.build_model()
    q4 = quantize_params(params, bits=4, destroy=False)
    ids = tokenizer_depth_seg_token(cs.PROMPT, tok)
    preps = [cs._prepared(ids, cs._images(np.random.RandomState(11), h, w), 32)[0]
             for h, w in cs.ENGINE_SIZES]
    for label, p in (("A", params), ("D", q4)):
        cs._run_engine(label, cfg, p, [preps, preps], max_new=32)
    model4 = VCoderForCausalLM(cfg, q4)
    rng = np.random.RandomState(0)
    cs._serve(model4, tok, cs._images(rng, 300, 420), 2)  # warm-up
    rates = []
    for h, w in [(480, 640), (720, 540), (375, 500)]:
        pictures = cs._images(rng, h, w)
        t0 = time.perf_counter()
        cs._serve(model4, tok, pictures, 1)
        ttft = time.perf_counter() - t0
        t0 = time.perf_counter()
        cs._serve(model4, tok, pictures, 32)
        rates.append(31 / (time.perf_counter() - t0 - ttft))
    cs.log(f"int4 B=1 decode tok/s {[round(r, 2) for r in rates]}, p50 {np.median(rates):.2f} "
           "(host clock)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
