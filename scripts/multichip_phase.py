#!/usr/bin/env python3
"""``chip_smoke.py`` phase 15 alone: training and both serving engines over
a ``(data, fsdp, model)`` mesh, one process per rank, against the one-device
run.

    python3 scripts/multichip_phase.py

Builds the kernels (phase 2) in this process, so the ranks only load them,
then runs ``phase_sharded`` over one NCCL rank per card: four cards take
mesh (1, 2, 2), the real row and head split; two (1, 1, 2); one card a
one-rank group (1, 1, 1).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("multichip_phase: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    total = cs.phase_sharded()
    cs.log(f"phase 15 launches (rank 0): {json.dumps(total)}")
    cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
