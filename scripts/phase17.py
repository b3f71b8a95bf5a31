#!/usr/bin/env python3
"""``chip_smoke.py``'s 13B training alone, on one card: phase 3's K1 and K6
cases at the 13B training shape (``check_training_13b``), then phase 16's
build and save of VCoder-DS-13B (``phase_13b``) with phase 17
(``phase_train_13b``: the VCoder-DS stage and the VCoder-IT LoRA stage)
run in its directory.

    python3 scripts/phase17.py
    python3 scripts/phase17.py --find-it-lora-batch

The kernel cases are noted on stub entries and printed as the last line,
``{"kernels": [...]}``. The disk budget is reckoned with phase 10's 13.52
GiB directory, as in the whole run.

``--find-it-lora-batch`` finds the micro-batch that ``IT_LORA_BATCH``
holds: in phase 16's directory it runs 17a, then 17b at B = 4, 2, 1 in
turn (``IT_LORA_ROWS`` rows an update each time), logs each B that runs
out of device memory with its message and peak, and prints the largest
that fits as the last line, ``{"it_lora_batch": B}``.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASE10_GIB = 13.52  # phase 10's 7B directory, written earlier in the whole run


def find_it_lora_batch(ckpt: str) -> int:
    """17a, then 17b at B = 4, 2, 1 until one fits the card; its B."""
    tmp = tempfile.mkdtemp(prefix="vcoder_it_lora_batch_")
    try:
        tree = os.path.join(tmp, "cost")
        cs.make_train_tree(tree)
        cs.train_13b_ds(ckpt, tree, os.path.join(tmp, "ds"))
        for B in (4, 2, 1):
            gc.collect()
            torch.cuda.empty_cache()
            sub = os.path.join(tmp, f"b{B}")
            os.makedirs(sub)
            t0 = time.perf_counter()
            try:
                b = cs.train_13b_it_lora(ckpt, tree, sub, batch=B)
            except torch.cuda.OutOfMemoryError as e:
                cs.log(f"17b at B={B} ran out of memory after {time.perf_counter() - t0:.1f} s "
                       f"with {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated at "
                       f"most: {str(e)[:400]}")
                continue
            cs.log(f"17b at B={B} fits: {json.dumps(b)}")
            return B
        raise SystemExit("17b: no micro-batch of 4, 2 or 1 fits the card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--find-it-lora-batch", action="store_true",
                    help="find 17b's micro-batch instead of running phase 17")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase17: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.config import VCoderConfig

    t0 = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    if args.find_it_lora_batch:
        found = {}
        cs.phase_13b(PHASE10_GIB, then=lambda d: found.update(B=find_it_lora_batch(d)))
        cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
        print(json.dumps({"it_lora_batch": found["B"]}))
        return 0
    report = [dict(name=k) for k in ("flash_fwd_train", "flash_bwd")]
    t1 = time.perf_counter()
    cfg = VCoderConfig.standard("vcoder_ds_llava", "7b")  # phase 8's rows
    cs.check_training_13b(report, cs.training_layout(cfg, cs.DSSamples(20, 336)))
    cs.log(f"13B training kernel cases: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    p17 = {}
    totals = cs.phase_13b(PHASE10_GIB, then=lambda d: p17.update(cs.phase_train_13b(d)))
    cs.log(f"phases 16 and 17: {time.perf_counter() - t1:.1f} s, launches "
           f"{json.dumps(totals)} and {json.dumps(p17)}")
    cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps({"kernels": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
