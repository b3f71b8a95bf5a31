#!/usr/bin/env python3
"""The flash-attention backward (K6, ``vcoder_tpu_torch/csrc/flash_bwd.cu``)
on one GPU: its build report, its SASS, phase 3's four K6 cases, and an A/B
against another version of the source on the same card.

    python3 scripts/flash_bwd_ab.py                 # build, SASS, the K6 cases
    python3 scripts/flash_bwd_ab.py --base OLD.cu   # ... and the A/B (--base repeats)

``OLD.cu`` is a flash_bwd.cu with this tree's C entry point or with the
earlier one that took delta from the caller (for example
``git show 6a7d8e5:vcoder_tpu_torch/csrc/flash_bwd.cu``; its delta is then
computed in plain torch inside the timed call, as that tree's wrapper did);
it is built with the same nvcc command into a temporary directory. The A/B
times the training-step case (phase 8's first batch, B=4, T=2048, H=KH=32)
by CUDA-graph replay, in turns: the bases, this tree's twice, the bases in
reverse. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from scripts.flash_fwd_ab import sass_counts  # noqa: E402

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The entry point that took delta from the caller (before the dq kernel
# computed it): q k v dout lse delta qpos kvmask dq dk dv, B T S H KH D,
# q/k/v/dout strides, scale causal stream.
_CALLER_DELTA = [_P] * 11 + [_I] * 6 + [_L] * 12 + [_F, _I, _P]


def _base_launcher(src: Path, lib: Path):
    """A function running the library built from ``src`` with
    ``launch_flash_bwd``'s arguments."""
    from vcoder_tpu_torch.ops import _kernels
    from vcoder_tpu_torch.ops import flash_attention as fa

    if "float* delta, void* qs" in src.read_text():
        cdll = _kernels.load("flash_bwd", lib)

        def run(*args, **kw):
            real = _kernels._LIBS.get("flash_bwd")
            _kernels._LIBS["flash_bwd"] = cdll
            try:
                return fa.launch_flash_bwd(*args, **kw)
            finally:
                _kernels._LIBS["flash_bwd"] = real
        return run

    import torch

    cdll = ctypes.CDLL(str(lib))
    cdll.flash_bwd.argtypes = _CALLER_DELTA
    cdll.flash_bwd.restype = ctypes.c_int

    def run(q, k, v, out, lse, dout, pos, mask, *, causal, scale):
        B, T, H, D = q.shape
        S, KH = k.shape[1], k.shape[2]
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        err = cdll.flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), pos.data_ptr(), mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, T, S, H, KH, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], float(scale), int(causal), _kernels.stream_handle(q.device))
        _kernels.check(err, "flash_bwd (base)")
        return dq, dk, dv
    return run


def ab(bases: list, layout) -> dict:
    """Times of each base library and of this tree's on the training case,
    in turns: the bases in order, this tree's twice, the bases in reverse;
    each one's dq and dkv under the profiler; then this tree's call eagerly,
    by graph replay and under the profiler, twice, with the card's clock and
    power after each."""
    import torch

    from vcoder_tpu_torch.ops import _kernels
    from vcoder_tpu_torch.ops import flash_attention as fa

    tmp = Path(tempfile.mkdtemp(prefix="flash_bwd_base_"))
    runs = {}
    for i, src in enumerate(bases):
        out = tmp / f"libflash_bwd_base{i}.so"
        proc = subprocess.run(_kernels.nvcc_command(src, out), capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"build of {src} failed:\n{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if any(w in line for w in ("registers", "spill", "serialized", "Compiling entry")):
                cs.log(f"  ptxas[{src.name}] {line.strip()}")
        cs.log(f"sass {src.name}: {json.dumps(sass_counts(out))}")
        runs[f"{src.name}#{i}"] = _base_launcher(src, out)
    names = list(runs)
    runs["new"] = fa.launch_flash_bwd
    case = next(cs._k6_cases(layout))
    q, k, v, pos, mask, dout = (case[x] for x in ("q", "k", "v", "pos", "mask", "dout"))
    scale = q.shape[-1] ** -0.5
    o, lse = fa.launch_flash_fwd(q, k, v, pos, mask, causal=True, scale=scale)
    grads, times = {}, {n: [] for n in runs}
    for which in names + ["new", "new"] + names[::-1]:
        run = lambda f=runs[which]: f(q, k, v, o, lse, dout, pos, mask, causal=True, scale=scale)
        grads[which] = run()
        times[which].append(cs.graph_ms([run] * 3))
    torch.cuda.synchronize()
    for which in names:
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(grads[which], grads["new"])]
        cs.log(f"A/B {case['name']}: {which} {times[which]} ms, new {times['new']} ms; "
               f"max |dq, dk, dv diff| {diffs}")
    for which, f in runs.items():
        split = cs._device_ms(
            lambda: f(q, k, v, o, lse, dout, pos, mask, causal=True, scale=scale),
            ("flash_bwd_dq", "flash_bwd_dkv"))
        cs.log(f"  {which} under the profiler (ms): {json.dumps(split)}")
    run = lambda: fa.launch_flash_bwd(q, k, v, o, lse, dout, pos, mask, causal=True, scale=scale)
    smi = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"]
    for _ in range(2):
        cs.log(f"  this tree: eager {cs.cuda_ms(run, iters=20):.4f} ms, graph "
               f"{cs.graph_ms([run] * 3):.4f} ms, profiler "
               f"{json.dumps(cs._device_ms(run, ('flash_bwd_dq', 'flash_bwd_dkv')))}, "
               f"clocks/power {subprocess.run(smi, capture_output=True, text=True).stdout.strip()}")
    return times


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, action="append", default=[],
                    help="a flash_bwd.cu to A/B against (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.ops import _kernels

    cs.phase_device()
    secs = _kernels.build(["flash_fwd", "flash_bwd"])
    cs.log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    for line in _kernels.BUILD_LOG.get("flash_bwd", "").splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error", "warning",
                                   "serialized", "Compiling entry")):
            cs.log(f"  ptxas[flash_bwd] {line.strip()}")
    cs.log(f"sass flash_bwd: {json.dumps(sass_counts(_kernels._lib_path('flash_bwd')))}")
    report: list = []
    cfg7 = VCoderConfig.standard("vcoder_ds_llava", "7b")
    layout = cs.training_layout(cfg7, cs.DSSamples(20, cfg7.vision.image_size))
    cs.phase_flash_bwd_kernels(report, layout)
    if args.base:
        ab(args.base, layout)
    print(json.dumps({"kernels": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
