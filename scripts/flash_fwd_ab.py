#!/usr/bin/env python3
"""The flash-attention forward (K1, ``vcoder_tpu_torch/csrc/flash_fwd.cu``) on
one GPU: its build report, its SASS, phase 3's flash cases, and an A/B
against another version of the source on the same card.

    python3 scripts/flash_fwd_ab.py                 # build, SASS, the six cases
    python3 scripts/flash_fwd_ab.py --base OLD.cu   # ... and the A/B (--base repeats)

``OLD.cu`` is a flash_fwd.cu with the same C entry point (for example an
earlier commit's, ``git show <commit>:vcoder_tpu_torch/csrc/flash_fwd.cu``);
it is built with the same nvcc command into a temporary directory. The A/B
times the decoder prefill case (causal, T=1280, 1201 valid, S=1312, H=32,
D=128), the tower's d64 case (B=3, T=S=577, H=16, scale 1 on the strided
q/k/v views of a [B,T,3,H,64] buffer) and the training-step case (phase 8's
first batch, B=4, T=2048) by CUDA-graph replay, in turns: the bases, this
tree's twice, the bases in reverse. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def sass_counts(lib: Path) -> dict:
    """Counts of the tensor-core and TMA instructions in a library's SASS."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return {op: sum(line.count(op) for line in text.splitlines())
            for op in ("HGMMA", "UTMALDG", "HMMA", "MUFU.EX2", "WARPGROUP.DEPBAR",
                       "WARPGROUP.ARRIVE")}


def cases(layout):
    """(label, q, k, v, pos, mask, causal, scale) of the timed cases."""
    import torch

    main = cs._flash_case("main", 1, 1280, 1312, 32, 32, 128, causal=True, n_valid=1201)
    yield ("decoder prefill d128 causal T=1280 S=1312 H=32", main["q"], main["k"], main["v"],
           main["pos"], main["mask"], True, 128**-0.5)
    gen = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((3, 577, 3, 16, 64), generator=gen, device="cuda", dtype=torch.bfloat16)
    yield ("tower d64 B=3 T=S=577 H=16 (strided qkv views)", qkv[:, :, 0], qkv[:, :, 1],
           qkv[:, :, 2], None, None, False, 1.0)
    pos, mask = layout
    B, T = pos.shape
    tr = cs._flash_case("train", B, T, T, 32, 32, 128, causal=True, layout=layout, seed=14)
    yield (f"training B={B} T={T} H=32", tr["q"], tr["k"], tr["v"], tr["pos"], tr["mask"],
           True, 128**-0.5)


def ab(bases: list, layout) -> dict:
    """Times of each base library and of this tree's on each case, in turns:
    the bases in order, this tree's twice, the bases in reverse order."""
    import torch

    from vcoder_tpu_torch.ops import _kernels
    from vcoder_tpu_torch.ops import flash_attention as fa

    tmp = Path(tempfile.mkdtemp(prefix="flash_base_"))
    libs = {}
    for i, src in enumerate(bases):
        out = tmp / f"libflash_fwd_base{i}.so"
        proc = subprocess.run(_kernels.nvcc_command(src, out), capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"build of {src} failed:\n{proc.stdout}{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if any(w in line for w in ("registers", "spill", "injected", "serialized")):
                cs.log(f"  ptxas[{src.name}] {line.strip()}")
        cs.log(f"sass {src.name}: {json.dumps(sass_counts(out))}")
        libs[src.name] = _kernels.load("flash_fwd", out)
    names = list(libs)
    libs["new"] = _kernels.lib("flash_fwd")
    result = {}
    for label, q, k, v, pos, mask, causal, scale in cases(layout):
        outs, times = {}, {n: [] for n in libs}
        for which in names + ["new", "new"] + names[::-1]:
            _kernels._LIBS["flash_fwd"] = libs[which]
            run = lambda: fa.launch_flash_fwd(q, k, v, pos, mask, causal=causal, scale=scale)
            outs[which] = run()
            times[which].append(cs.graph_ms([run] * 5))
        _kernels._LIBS["flash_fwd"] = libs["new"]
        torch.cuda.synchronize()
        for which in names:
            diff = (outs[which][0].float() - outs["new"][0].float()).abs().max().item()
            lse_diff = (outs[which][1] - outs["new"][1]).abs().max().item()
            cs.log(f"A/B {label}: {which} {times[which]} ms, new {times['new']} ms; "
                   f"max |out diff| {diff:.3e}, max |lse diff| {lse_diff:.3e}")
        result[label] = times
        del q, k, v
        torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, action="append", default=[],
                    help="a flash_fwd.cu to A/B against (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.ops import _kernels

    cs.phase_device()
    secs = _kernels.build(["flash_fwd"])
    cs.log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    for line in _kernels.BUILD_LOG.get("flash_fwd", "").splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error", "warning",
                                   "injected", "serialized")):
            cs.log(f"  ptxas[flash_fwd] {line.strip()}")
    cs.log(f"sass flash_fwd: {json.dumps(sass_counts(_kernels._lib_path('flash_fwd')))}")
    report: list = []
    cfg7 = VCoderConfig.standard("vcoder_ds_llava", "7b")
    layout = cs.training_layout(cfg7, cs.DSSamples(20, cfg7.vision.image_size))
    cs.phase_flash_kernels(report)
    cs.check_flash_training(report, layout)
    if args.base:
        ab(args.base, layout)
    print(json.dumps({"kernels": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
