"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It makes the cell's weights and traffic from
the seed on the card, warms up the cell's shapes, measures for ``--seconds``
seconds, checks the timed path's outputs against the plain reference, and
prints one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``check`` (each number compared, with its limit). It exits non-zero and
prints no result without a card, without the port, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Modules no run may hold, compared by whole top-level name.
BANNED = {"jax", "jaxlib", "flax", "vcoder_tpu"}


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    own kernels into ``vcoder_tpu_torch/_build``); transformers kept off
    JAX."""
    base = root / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(workload: str, seed: int, seconds: float, trace: bool, device, *,
            t_start: float = T_START, bench=None, base=None, fault=None, mix_update=None):
    """One run of ``workload``; returns (result dict, the Run). ``base`` (a
    directory with ``cells/``, ``configs/`` and ``traffic/``) and ``bench``
    let a test run a cell of its own; ``fault`` breaks the timed path
    underneath (``drive.py``); ``mix_update`` replaces parameters of the
    mix (the rate sweep's)."""
    from portbench import check, drive, spec

    base = spec.HERE if base is None else Path(base)
    bench = spec.benchmark() if bench is None else bench
    cell = spec.cell(workload, base / "cells")
    cfg = spec.config(cell["config"], base / "configs")
    mix = {**spec.mix(cell["traffic"], base / "traffic"), **(mix_update or {})}
    kind = drive.run_train if mix["kind"] == "train" else drive.run_serve
    run = kind(cell, cfg, mix, seed, seconds, trace, device, t_start, fault=fault)

    metrics = {}
    for m in spec.metrics_of(bench, workload, trace):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": int(cell["chips"]),
           "memory_peak_bytes": run.memory_peak}
    result = {"correct": check.correct(run.check) and run.failed == 0,
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    # A number that could not be read (nothing finished to compare) prints
    # as null: JSON has no infinity.
    result["check"] = {k: {kk: (v if math.isfinite(v) else None) for kk, v in e.items()}
                       for k, e in run.check.items()}
    return result, run


def by_chunk(run, chunk_s: float = 10.0) -> list:
    """Tokens a second in each ``chunk_s`` of the window, by when each step
    ended (the last chunk takes what is left over): where in a run it
    slowed."""
    n = max(int(run.window_s // chunk_s), 1)
    tokens = [0] * n
    for st in run.steps:
        tokens[min(int((st.t1 - run.t0) // chunk_s), n - 1)] += st.tokens
    return [x / (chunk_s if i < n - 1 else run.window_s - chunk_s * (n - 1))
            for i, x in enumerate(tokens)]


def _device_name(device) -> str:
    if device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device)
    return device.type


def _launches() -> dict:
    out = {}
    fa = sys.modules.get("vcoder_tpu_torch.ops.flash_attention")
    pa = sys.modules.get("vcoder_tpu_torch.ops.paged_attention")
    if fa is not None:
        out.update(flash_fwd=fa.launches, flash_bwd=fa.bwd_launches)
    if pa is not None:
        out.update(paged_k8=pa.launches_k8, paged_bf16=pa.launches_bf16,
                   paged_q8=pa.launches_q8, paged_fused=pa.launches_fused)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_dirs(ROOT)

    from portbench import spec

    cell = spec.cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    import vcoder_tpu_torch  # noqa: F401  (fails here without the port)

    device = torch.device("cuda", 0)
    result, run = execute(a.workload, a.seed, a.seconds, bool(a.trace), device)
    found = banned_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    notes = {k: v for k, v in run.notes.items()}
    notes.update(window_s=run.window_s, steps=len(run.steps), launches=_launches(),
                 steps_per_s=len(run.steps) / run.window_s, tokens_per_s_by_10s=by_chunk(run))
    if run.trace is not None:
        notes["slice_steps_per_s"] = len(run.traced) / run.trace.window_s
    print("portbench notes: " + json.dumps(notes, default=str))
    for name, e in result["check"].items():
        print(f"check {name} {e['value']!r} limit {e['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
