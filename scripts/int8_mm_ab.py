#!/usr/bin/env python3
"""The int8 GEMM (K10, ``vcoder_tpu_torch/csrc/int8_mm.cu``) on one GPU: its
build report, its SASS, both forms at phase 3's cases, and A/Bs on the same
card.

    python3 scripts/int8_mm_ab.py                 # build, SASS, the seven cases
    python3 scripts/int8_mm_ab.py --base OLD.cu   # ... and an A/B (--base repeats)
    python3 scripts/int8_mm_ab.py --faults        # ... and the broken variants

The cases are ``chip_smoke.INT8_CASES``: the six W8A8 products of a
quantized 7B prefill and a ragged one (M=333, K=1040, N=1200), each checked
in both forms against its plain version (s32 exact, scaled within one bf16
rounding) and timed by CUDA-graph replay beside ``torch._int_mm``.

``OLD.cu`` is an int8_mm.cu with the same C entry point (for example
``git show c6145bc:vcoder_tpu_torch/csrc/int8_mm.cu``), built with the same
nvcc command into a temporary directory; the A/B times both forms at every
case in turns: the bases, this tree's twice, the bases in reverse.
``--faults`` builds copies of this source with one deliberate fault each
(``FAULTS``) and runs every case through the checks: the sound kernel must
pass everywhere and every fault must fail somewhere. Exits non-zero when a
check fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import _ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

KERNEL = "int8_mm"

# SASS opcodes counted in the build report: every warpgroup MMA ("*GMMA",
# IGMMA for s8), the TMA loads, the mma.sync form of the earlier kernel
# (IMMA) and the waits that show ptxas serialized the wgmma.
SASS_OPS = ("UTMALDG", "IMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE")
_GMMA = re.compile(r"\b([A-Z]*GMMA)\b")

# One fault per entry: (line of int8_mm.cu, its broken form).
FAULTS = {
    "skipped k-stage (stage 1 loaded past K)": (
        "const int k0 = kb * BK;",
        "const int k0 = kb == 1 ? K : kb * BK;"),
    "weight fragments read without the swizzle": (
        "const uint32_t lrow = krow * 128 + ((chunk ^ (krow & 7)) << 4);",
        "const uint32_t lrow = krow * 128 + (chunk << 4);"),
    "epilogue one column pair off": (
        "const int n = n0 + 64 * wg + 16 * warp + 2 * (lane / 4);",
        "const int n = n0 + 64 * wg + 16 * warp + 2 * (lane / 4) + 2;"),
    "K's zero fill disabled (maps declare K rounded up to 128)": (
        "const long long kdim = K;",
        "const long long kdim = (K + BK - 1) / BK * BK;"),
}


def sass_counts(lib: Path) -> dict:
    """Counts of the warpgroup MMA opcodes and of ``SASS_OPS`` in a library."""
    text = _ab.sass(lib)
    counts: dict = {}
    for line in text.splitlines():
        for op in _GMMA.findall(line):
            counts[op] = counts.get(op, 0) + 1
    for op in SASS_OPS:
        counts[op] = sum(line.count(op) for line in text.splitlines())
    return counts


def _log_build(label: str, text: str) -> None:
    for line in text.splitlines():
        if any(w in line for w in ("registers", "spill", "error", "warning", "serialized",
                                   "Compiling entry")):
            cs.log(f"  ptxas[{label}] {line.strip()}")


def build_variants(sources: dict, tmp: Path) -> dict:
    """Builds {label: source text} in parallel into ``tmp``; returns {label:
    library} with ``int8_mm``'s C signature."""
    return _ab.finish_variants(KERNEL, _ab.start_variants(sources, tmp), _log_build)


substituted = functools.partial(_ab.substituted, KERNEL)  # (subs) -> this tree's source
library = functools.partial(_ab.library, KERNEL)  # with library(cdll): ...


def turns(runs: dict, first: list) -> dict:
    """Per-call ms of each build in ``runs`` ({label: (cdll, fn)}), by
    CUDA-graph replay in turns: ``first`` in order, "new" twice, ``first``
    in reverse."""
    times: dict = {k: [] for k in runs}
    for which in first + ["new", "new"] + first[::-1]:
        cdll, fn = runs[which]
        with library(cdll):
            times[which].append(round(cs.graph_ms([fn] * 5), 5))
    return times


def ab(libs: dict) -> dict:
    """Both forms of every case, each base against this tree's kernel."""
    import torch

    from vcoder_tpu_torch.ops import int8_matmul as i8

    out = {}
    names = list(libs)
    for label, M, K, N in cs.INT8_CASES:
        a, b, sa, sb = cs.int8_operands(M, K, N)
        want = i8.launch_int8_mm(a, b)
        for name, cdll in libs.items():
            with library(cdll):
                got = i8.launch_int8_mm(a, b)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                cs.log(f"A/B {label}: {name} disagrees with this tree's s32 product")
        for form, fn in (("s32", lambda: i8.launch_int8_mm(a, b)),
                         ("scaled", lambda: i8.launch_int8_mm_scaled(a, b, sa, sb))):
            runs = {n: (libs[n], fn) for n in names}
            runs["new"] = (None, fn)
            t = turns(runs, names)
            out[f"{label} {form}"] = t
            cs.log(f"A/B {label} M={M} K={K} N={N} {form}: "
                   + "  ".join(f"{n} {t[n]} ms" for n in names + ["new"]))
        del a, b, want
        torch.cuda.empty_cache()
    return out


def faults(libs: dict) -> bool:
    """Every case through the checks with the sound kernel and each fault.
    True when the sound kernel passes everywhere and each fault fails
    somewhere."""
    import torch

    failed: dict = {}
    for label, M, K, N in cs.INT8_CASES:
        a, b, sa, sb = cs.int8_operands(M, K, N)
        for name, cdll in [("sound", None)] + list(libs.items()):
            with library(cdll):
                try:
                    agree = cs.int8_agreement(a, b, sa, sb)
                except RuntimeError as e:  # a refused launch fails the check too
                    agree = dict(ok=False, error=str(e))
            torch.cuda.synchronize()
            cs.log(f"faults {label} [{name}]: "
                   + json.dumps({k: v for k, v in agree.items()}))
            failed[name] = failed.get(name, False) or not agree["ok"]
        del a, b
        torch.cuda.empty_cache()
    sound_failed = failed.pop("sound")
    cs.log(f"faults: sound {'FAILED' if sound_failed else 'passed'} everywhere; "
           + json.dumps({k: ("caught" if v else "NOT caught") for k, v in failed.items()}))
    return not sound_failed and all(failed.values())


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, action="append", default=[],
                    help="an int8_mm.cu to A/B against (repeatable)")
    ap.add_argument("--faults", action="store_true", help="build and run the broken variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_mm_ab: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.ops import _kernels

    cs.phase_device()
    secs = _kernels.build(["int8_mm"])
    cs.log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
    _log_build("int8_mm", _kernels.BUILD_LOG.get("int8_mm", ""))
    cs.log(f"sass int8_mm: {json.dumps(sass_counts(_kernels._lib_path('int8_mm')))}")
    report: list = []
    for label, M, K, N in cs.INT8_CASES:
        cs.check_int8(label, M, K, N, report if (M, K, N) == cs.INT8_MAIN else None)
    ok = True
    with tempfile.TemporaryDirectory(prefix="int8_mm_ab_") as tmp:
        sources = {f"{p.name}#{i}": p.read_text() for i, p in enumerate(args.base)}
        if args.faults:
            sources.update({label: substituted([sub]) for label, sub in FAULTS.items()})
        libs = build_variants(sources, Path(tmp)) if sources else {}
        for name, cdll in libs.items():
            cs.log(f"sass {name}: {json.dumps(sass_counts(Path(cdll._name)))}")
        if args.base:
            ab({n: libs[n] for n in libs if "#" in n})
        if args.faults:
            ok = faults({n: libs[n] for n in FAULTS})
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
           "--format=csv,noheader"]
    cs.log(f"card after the runs: {subprocess.run(smi, capture_output=True, text=True).stdout.strip()}")
    print(json.dumps({"kernels": report}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
