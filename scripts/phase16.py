#!/usr/bin/env python3
"""``chip_smoke.py``'s 13B work alone, on one card: phase 3's serving
kernels at the 13B decoder's shapes (``phase_kernels_13b``), then phase 16
(``phase_13b``: VCoder-DS-13B through ``generate``, engines A13, E13 and
D13, a 13B directory saved, quantized in place and loaded with
``load_4bit``).

    python3 scripts/phase16.py

The kernel cases are noted on stub entries of each kernel and printed as
the last line, ``{"kernels": [...]}``. The disk budget is reckoned with
phase 10's 13.52 GiB directory, as in the whole run.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KERNELS = ("flash_fwd", "paged_attn_k8", "paged_attn_bf16", "paged_attn_q8", "paged_attn_fused",
           "int4_matmul", "int8_mm", "int8_mm_scaled")
PHASE10_GIB = 13.52  # phase 10's 7B directory, written earlier in the whole run


def main() -> int:
    if not torch.cuda.is_available():
        print("phase16: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    report = [dict(name=k) for k in KERNELS]
    t1 = time.perf_counter()
    cs.phase_kernels_13b(report)
    cs.log(f"13B kernel cases: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    totals = cs.phase_13b(PHASE10_GIB)
    cs.log(f"phase 16: {time.perf_counter() - t1:.1f} s, launches {json.dumps(totals)}")
    cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
