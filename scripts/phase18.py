#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 18 alone: the LLaVA full finetune at 13B with
the Adam moments offloaded to pinned host memory (``train.train --stage
full --offload-opt-state``), on one card or over four.

    python3 scripts/phase18.py                    # one card: phase 18
    python3 scripts/phase18.py --find-full-batch  # one card: FULL_BATCH_13B
    python3 scripts/phase18.py --mesh             # four cards, mesh (1, 4, 1)

Every form builds the kernels, draws VCoder-DS-13B's seeded random bf16
weights (``build_model("13b")``, as phase 16 does) and writes them with
``full_vocab_tokenizer``'s tokenizer into a temporary
``vcoder_ds_llava-v1.5-13b`` directory (25.35 GiB on disk), then drops
them.

* No flag: ``phase_full_13b`` in that directory at ``FULL_BATCH_13B``,
  logged and gated as in the whole run (~5 min of command).
* ``--find-full-batch``: ``phase_full_13b`` at B = 4, 2, 1 in turn; each B
  that runs out of device memory is logged with its message and peak, and
  the largest that runs, passing every gate, is printed as the last line,
  ``{"full_batch": B}``.
* ``--mesh`` (four cards on one host): first, on card 0, the one-device
  reference of step 1 (``full_mesh_reference``: the ranks' global batch in
  micro-batches of ``FULL_BATCH_13B`` rows, the gradients summed in f32 on
  the host); then four NCCL ranks (``parallel/launch.spawn``), each running
  ``train.train --stage full --offload-opt-state --mesh-fsdp 4`` under the
  group (``full_mesh_rank``: each rank loads leaf by leaf, keeps its quarter
  of the moments in its own pinned memory, rank 0's weight files go through
  pipes), ``MESH_STEPS`` steps, then the resident/offloaded A/B on its
  shards. The per-device batch is the largest of ``MESH_BATCHES`` that
  runs (a rank out of device memory is logged and the next B tried; any
  other failure ends the run).
  Gated by ``full_mesh_gates``; the last line is ``{"mesh": {...}}``.
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


def write_13b_dir(tmp: str) -> str:
    """VCoder-DS-13B's seeded weights and the tokenizer in ``tmp``; the
    weights are dropped from the card afterwards."""
    from vcoder_tpu_torch.checkpoint import save_pretrained

    cfg, params, model, _ = cs.build_model("13b")
    d = os.path.join(tmp, cs.DIR_13B)
    t0 = time.perf_counter()
    save_pretrained(d, params, cfg)
    cs.full_vocab_tokenizer(cfg).save_pretrained(d)
    cs.log(f"13B directory written in {time.perf_counter() - t0:.1f} s ({cs._dir_gib(d):.2f} GiB)")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return d


def _oom(text: str) -> bool:
    return "OutOfMemoryError" in text or "CUDA out of memory" in text


def find_full_batch(d: str) -> int:
    """Phase 18 at B = 4, 2, 1 until one runs; that B."""
    for B in (4, 2, 1):
        gc.collect()
        torch.cuda.empty_cache()
        cs._host_empty_cache()
        t0 = time.perf_counter()
        try:
            got = cs.phase_full_13b(d, batch=B)
        except torch.cuda.OutOfMemoryError as e:
            cs.log(f"18 at B={B} ran out of memory after {time.perf_counter() - t0:.1f} s with "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated at most: "
                   f"{str(e)[:400]}")
            continue
        cs.log(f"18 at B={B} runs: step p50 {got['step_ms_p50']:.1f} ms, peak "
               f"{got['peak_gib']:.2f} GiB")
        return B
    raise SystemExit("18: no batch of 4, 2 or 1 fits the card")


def run_mesh(d: str, tmp: str, steps: int) -> dict:
    """The four-card stage at the largest per-device batch of
    ``MESH_BATCHES`` that runs; its gates and readings."""
    from vcoder_tpu_torch.parallel import launch

    world = cs.MESH_FSDP
    if torch.cuda.device_count() < world:
        raise SystemExit(f"--mesh needs {world} cards, this machine has "
                         f"{torch.cuda.device_count()}")
    base = os.path.join(tmp, cs.LLAVA_DIR_13B)
    cs.write_llava_dir(base, d)
    for B in cs.MESH_BATCHES:
        data, out = os.path.join(tmp, f"llava-{B}.json"), os.path.join(tmp, f"out-{B}")
        cs.make_llava_json(data, n=steps * world * B)
        argv = cs._stage_argv(base, data, out, B, steps, "cuda") + [
            "--mesh-data", "1", "--mesh-fsdp", str(world), "--mesh-model", "1"]
        t0 = time.perf_counter()
        ref = cs.full_mesh_reference(argv, world, cs.FULL_BATCH_13B)
        ref_s = time.perf_counter() - t0
        cs.log(f"  reference on one card: {ref['rows']} rows in micro-batches of "
               f"{cs.FULL_BATCH_13B}, T={ref['T']}, loss {ref['loss']:.6f}, grad norm "
               f"{ref['grad_norm']:.6f} ({ref_s:.1f} s)")
        t0 = time.perf_counter()
        try:
            ranks = launch.spawn(cs.full_mesh_rank, world, argv, device="cuda", timeout_s=900)
        except RuntimeError as e:
            if not _oom(str(e)):
                raise
            cs.log(f"  mesh at B={B} a device ran out of memory after "
                   f"{time.perf_counter() - t0:.1f} s: {str(e)[-1200:]}")
            shutil.rmtree(out, ignore_errors=True)
            continue
        ranks_s = time.perf_counter() - t0
        summary, bad = cs.full_mesh_gates(ranks, ref, B, steps)
        summary.update(reference_s=round(ref_s, 1), ranks_s=round(ranks_s, 1),
                       ref_leaf_norms=len(ref["norms"]))
        cs.log("mesh18: " + json.dumps(summary, default=float))
        if bad:
            raise SystemExit("18 over the mesh: " + "; ".join(bad))
        return summary
    raise SystemExit(f"18 over the mesh: no per-device batch of {cs.MESH_BATCHES} fits")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--find-full-batch", action="store_true",
                      help="find FULL_BATCH_13B instead of running phase 18 at it")
    mode.add_argument("--mesh", action="store_true",
                      help="the stage over four cards, mesh (1, 4, 1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase18: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    tmp = tempfile.mkdtemp(prefix="phase18_")
    try:
        d = write_13b_dir(tmp)
        if args.find_full_batch:
            result = {"full_batch": find_full_batch(d)}
        elif args.mesh:
            result = {"mesh": run_mesh(d, tmp, cs.MESH_STEPS)}
        else:
            result = {"phase18": cs.phase_full_13b(d)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
    print(json.dumps(result, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
