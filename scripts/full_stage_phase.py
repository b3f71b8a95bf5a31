#!/usr/bin/env python3
"""``chip_smoke.py`` phase 14 alone on one GPU: the full-LLM stage with the
Adam moments offloaded, then its resident/offloaded A/B.

    python3 scripts/full_stage_phase.py

Builds the kernels (phase 2), VCoder-DS-7B with seeded random bf16 weights
(``build_model``), writes them and ``full_vocab_tokenizer``'s tokenizer as
phase 10 does into a temporary ``SURFACE_DIR`` directory, drops the weights
and runs ``phase_full_stage`` on that directory, which logs and gates as
in the whole run. ~185 s of command time on an H100.
"""

import gc
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("full_stage_phase: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.checkpoint import save_pretrained

    t0 = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    cfg, params, model, _ = cs.build_model()
    tmp = tempfile.mkdtemp(prefix="full_stage_")
    try:
        d = os.path.join(tmp, cs.SURFACE_DIR)
        t1 = time.perf_counter()
        save_pretrained(d, params, cfg)
        cs.full_vocab_tokenizer(cfg).save_pretrained(d)
        cs.log(f"DS dir written in {time.perf_counter() - t1:.1f} s")
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        res = cs.phase_full_stage(d)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log(f"result {res}")
    cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
