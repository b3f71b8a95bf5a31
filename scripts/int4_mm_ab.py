#!/usr/bin/env python3
"""The int4 decode matmul (K5, ``vcoder_tpu_torch/csrc/int4_matmul.cu``) on
one GPU: its build report, its SASS, phase 3's cases, and A/Bs on the same
card.

    python3 scripts/int4_mm_ab.py                 # build, SASS, the K5 cases
    python3 scripts/int4_mm_ab.py --base OLD.cu   # ... and an A/B (--base repeats)
    python3 scripts/int4_mm_ab.py --faults        # ... and the broken variants
    python3 scripts/int4_mm_ab.py --floor         # ... and the kernel without its products

The cases are ``chip_smoke.int4_cases``: the 7B decoder's q/k/v/o, gate/up
and down products and lm_head at B=1 and B=8, each checked against the
plain version (two bf16 ulps), the scaled form bit-equal to the product
times the scale, two launches bit-identical, and timed by CUDA-graph replay
over weight copies that keep L2 cold, beside a bf16 matmul over the
dequantized weight; then the ragged cases, untimed.

``OLD.cu`` is an int4_matmul.cu with the entry point of the CUDA-core
kernel that preceded this one (``int4_matmul(x, qp, part, out, B, K2, N,
sx, splits, rows_per_split, out_f32, stream)``, f32 partials over K added
by a second kernel; for example ``git show
fdf34d1:vcoder_tpu_torch/csrc/int4_matmul.cu``), built with the same nvcc
command into a temporary directory and called with that kernel's split
rule. The A/B times, at every timed case, in turns (the bases, this tree's
twice, the bases in reverse): the product alone, and the route as
``qmatmul`` runs it (this tree: one launch with the scale; a base: its
product, then the scale cast and multiplied in torch).
``--faults`` builds copies of this source with one deliberate fault each
(``FAULTS``) and runs every case through the checks: the sound kernel must
pass everywhere and every fault must fail somewhere. ``--floor`` times,
at the timed cases, a copy whose products are replaced by one XOR a step
(``FLOOR``): the same loads, split and reduction, so the kernel's time
less the floor's is what the unpacking and the products add. Exits
non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import functools
import ctypes
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

KERNEL = "int4_matmul"

# SASS opcodes counted in the build report: the tensor-core products
# (HMMA), the CUDA-core FMAs of the earlier per-row loop (FFMA), the unpack
# (PRMT, LOP3, HFMA2/HADD2), the 16-byte global and shared loads and TMA.
SASS_OPS = ("HMMA", "FFMA", "PRMT", "LOP3", "HFMA2", "HADD2", "UTMALDG")
_LDG128 = re.compile(r"\bLDG\.[A-Z0-9.]*128\b")
_LDS128 = re.compile(r"\bLDS\.[A-Z0-9.]*128\b")
_FUNC = re.compile(r"Function : (\S+)")

# One fault per entry: (line of int4_matmul.cu, its broken form).
FAULTS = {
    "lo and hi nibbles swapped": (
        "const uint32_t y = __byte_perm(w, s, p | ((p + 4) << 8));",
        "const uint32_t y = __byte_perm(s, w, p | ((p + 4) << 8));"),
    "every warp's second k-step skipped": (
        "        if (i0 + u < n) step(acc, wa[buf][u], wb[buf][u], wx[buf][u]);",
        "        if (i0 + u < n && i0 + u != 1) step(acc, wa[buf][u], wb[buf][u], wx[buf][u]);"),
    "columns c + 2j and c + 2j + 1 swapped in row 2t": (
        "make_float4(acc[j][0], acc[j][2], acc[j + 1][0], acc[j + 1][2]);",
        "make_float4(acc[j][2], acc[j][0], acc[j + 1][0], acc[j + 1][2]);"),
    "split reduced without the cluster barrier": (
        "  // the tile from the cluster's sums, added in rank order.\n  cluster.sync();",
        "  // the tile from the cluster's sums, added in rank order."),
}

# The floor: every step's products replaced by one XOR of its words, so
# the loads stay live (the results are wrong by design, and not checked).
FLOOR = ("        if (i0 + u < n) step(acc, wa[buf][u], wb[buf][u], wx[buf][u]);",
         "        acc[0][0] += __uint_as_float((wa[buf][u].x ^ wb[buf][u].y ^ wx[buf][u].x)"
         " & 0x3f800000u);")

# The C signature of the earlier entry point (see the module docstring).
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
OLD_ARGTYPES = [_P] * 4 + [_I] * 3 + [_L] + [_I] * 3 + [_P]


def sass_counts(lib: Path) -> dict:
    """Counts of ``SASS_OPS``, of 16-byte global and shared loads, and the
    kernels (functions) in a library."""
    text = _ab.sass(lib)
    lines = text.splitlines()
    counts: dict = {op: sum(len(re.findall(r"\b" + op + r"\b", ln)) for ln in lines)
                    for op in SASS_OPS}
    counts["LDG.128"] = sum(len(_LDG128.findall(ln)) for ln in lines)
    counts["LDS.128"] = sum(len(_LDS128.findall(ln)) for ln in lines)
    counts["functions"] = sorted(set(_FUNC.findall(text)))
    return counts


def _log_build(label: str, text: str) -> None:
    for line in text.splitlines():
        if any(w in line for w in ("registers", "spill", "error", "warning", "Compiling entry")):
            cs.log(f"  ptxas[{label}] {line.strip()}")


def finish_variants(procs: dict) -> dict:
    """Waits for the builds of ``_ab.start_variants``; returns {label:
    loaded library} (a base, whose label holds "#", with the earlier
    signature; the others with this tree's)."""
    return _ab.finish_variants(KERNEL, procs, _log_build, old_argtypes=OLD_ARGTYPES)


substituted = functools.partial(_ab.substituted, KERNEL)  # (subs) -> this tree's source
library = functools.partial(_ab.library, KERNEL)  # with library(cdll): ...


def old_call(cdll, x, qp):
    """A launch function for the earlier kernel on (x, qp): its split rule,
    its f32 scratch allocated once, outside the timed calls."""
    import torch

    from vcoder_tpu_torch.ops import _kernels

    B, _ = x.shape
    k_half, N = qp.shape
    splits = max(1, min(-(-264 // -(-N // 128)), k_half // 256))
    rows = -(-k_half // splits)
    part = torch.empty((splits, B, N), dtype=torch.float32, device=x.device)
    out = torch.empty((B, N), dtype=torch.bfloat16, device=x.device)

    def run(q=qp):
        err = cdll.int4_matmul(x.data_ptr(), q.data_ptr(), part.data_ptr(), out.data_ptr(), B,
                               k_half, N, x.stride(0), splits, rows, 0,
                               _kernels.stream_handle(x.device))
        _kernels.check(err, "int4_matmul (base)")
        return out

    return run


def ab(libs: dict) -> dict:
    """The product and the route at every timed case, each base against
    this tree's kernel, in turns."""
    import torch

    from vcoder_tpu_torch.ops import int4_matmul as i4

    out = {}
    names = list(libs)
    for B in (1, 8):
        for label, K, N in cs.INT4_SHAPES:
            x, qp, scale = cs.int4_operands(B, K, N)
            copies = cs._copies(qp, K // 2 * N)
            want = i4.launch_int4_matmul(x, qp)
            runs = {n: old_call(libs[n], x, qp) for n in names}
            for n, run in runs.items():
                got = run().clone()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                cs.log(f"A/B {label} B={B}: {n} against this tree's product, max-abs {err:.3e}")
            forms = {
                "product": ({n: (lambda r=runs[n]: [lambda q=q: r(q) for q in copies]) for n in names},
                            lambda: [lambda q=q: i4.launch_int4_matmul(x, q) for q in copies]),
                "route": ({n: (lambda r=runs[n]: [lambda q=q: r(q) * scale.to(torch.bfloat16)
                                                  for q in copies]) for n in names},
                          lambda: [lambda q=q: i4.launch_int4_matmul(x, q, scale) for q in copies]),
            }
            for form, (base_fns, new_fns) in forms.items():
                times: dict = {n: [] for n in names + ["new"]}
                for which in names + ["new", "new"] + names[::-1]:
                    fns = new_fns() if which == "new" else base_fns[which]()
                    times[which].append(round(cs.graph_ms(fns), 5))
                out[f"{label} B={B} {form}"] = times
                cs.log(f"A/B {label} B={B} K={K} N={N} {form}: "
                       + "  ".join(f"{n} {times[n]} ms" for n in names + ["new"]))
            del x, qp, copies, runs
            torch.cuda.empty_cache()
    return out


def floor(cdll) -> dict:
    """Per-call ms of the floor build at every timed case (graph replay over
    weight copies, as the kernel is timed)."""
    import torch

    from vcoder_tpu_torch.ops import int4_matmul as i4

    out = {}
    with library(cdll):
        for B in (1, 8):
            for label, K, N in cs.INT4_SHAPES:
                x, qp, _ = cs.int4_operands(B, K, N)
                copies = cs._copies(qp, K // 2 * N)
                ms = cs.graph_ms([lambda q=q: i4.launch_int4_matmul(x, q) for q in copies])
                out[f"{label} B={B}"] = round(ms, 5)
                del x, qp, copies
                torch.cuda.empty_cache()
    cs.log(f"floor (loads, split and reduction; no products), ms: {json.dumps(out)}")
    return out


def faults(libs: dict) -> bool:
    """Every case through the checks with the sound kernel and each fault.
    True when the sound kernel passes everywhere and each fault fails
    somewhere."""
    import torch

    cases = [(label, B, K, N, 0) for B in (1, 8) for label, K, N in cs.INT4_SHAPES]
    cases += [("ragged", B, K, N, sx) for B, K, N, sx in cs.INT4_RAGGED]
    failed: dict = {}
    for label, B, K, N, sx in cases:
        x, qp, scale = cs.int4_operands(B, K, N, sx)
        for name, cdll in [("sound", None)] + list(libs.items()):
            with library(cdll):
                try:
                    agree = cs.int4_agreement(x, qp, scale)
                except RuntimeError as e:  # a refused launch fails the check too
                    agree = dict(ok=False, error=str(e))
            torch.cuda.synchronize()
            cs.log(f"faults {label} B={B} K={K} N={N} [{name}]: {json.dumps(agree)}")
            failed[name] = failed.get(name, False) or not agree["ok"]
        del x, qp
        torch.cuda.empty_cache()
    sound_failed = failed.pop("sound")
    cs.log(f"faults: sound {'FAILED' if sound_failed else 'passed'} everywhere; "
           + json.dumps({k: ("caught" if v else "NOT caught") for k, v in failed.items()}))
    return not sound_failed and all(failed.values())


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, action="append", default=[],
                    help="an int4_matmul.cu with the earlier entry point to A/B against "
                         "(repeatable)")
    ap.add_argument("--faults", action="store_true", help="build and run the broken variants")
    ap.add_argument("--floor", action="store_true", help="time the kernel without its products")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int4_mm_ab: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.ops import _kernels

    cs.phase_device()
    with tempfile.TemporaryDirectory(prefix="int4_mm_ab_") as tmp:
        # Every build at once: this tree's source, the bases, the faults.
        sources = {f"{p.name}#{i}": p.read_text() for i, p in enumerate(args.base)}
        if args.faults:
            sources.update({label: substituted([sub]) for label, sub in FAULTS.items()})
        if args.floor:
            sources["floor"] = substituted([FLOOR])
        procs = _ab.start_variants(sources, Path(tmp))
        secs = _kernels.build(["int4_matmul"])
        cs.log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
        _log_build("int4_matmul", _kernels.BUILD_LOG.get("int4_matmul", ""))
        libs = finish_variants(procs)
        counts = sass_counts(_kernels._lib_path("int4_matmul"))
        cs.log(f"sass int4_matmul: {json.dumps(counts)}")
        for name, cdll in libs.items():
            cs.log(f"sass {name}: {json.dumps(sass_counts(Path(cdll._name)))}")
        ok = not any("split_sum" in f for f in counts["functions"]) and counts["HMMA"] > 0
        from vcoder_tpu_torch.ops import int4_matmul as i4

        cs.log("blocks one wave holds, clusters of 1..8 (int4_matmul_capacity): "
               f"{i4._capacity(torch.cuda.current_device())}")
        report: list = []
        rows = cs.int4_cases(report)
        if args.base:
            ab({n: libs[n] for n in libs if "#" in n})
        if args.floor:
            floor(libs["floor"])
        if args.faults:
            ok = faults({n: libs[n] for n in FAULTS}) and ok
    cs.log("cases: " + json.dumps(rows))
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
           "--format=csv,noheader"]
    cs.log(f"card after the runs: {subprocess.run(smi, capture_output=True, text=True).stdout.strip()}")
    print(json.dumps({"kernels": report}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
