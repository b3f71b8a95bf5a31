#!/usr/bin/env python3
"""The paged attention kernel's SPLIT body (K4 and K7 at C <= 16,
``vcoder_tpu_torch/csrc/paged_attn.cu``) on one GPU: its build report, its
SASS, every K4/K7 case of ``chip_smoke.py``'s phases 3 and 9, and A/Bs on
the same card.

    python3 scripts/paged_attn_ab.py                 # build, SASS, the K4/K7 cases
    python3 scripts/paged_attn_ab.py --base OLD.cu   # ... and an A/B (--base repeats)
    python3 scripts/paged_attn_ab.py --faults        # ... and the broken variants
    python3 scripts/paged_attn_ab.py --floor         # ... and the body without its products

The cases are ``chip_smoke.PAGED_CASES`` that take the SPLIT body (the int8
ones but the chunk window) and every ``chip_smoke.FUSED_CASES`` case, each
checked against the plain version (``paged_agreement`` / ``fused_agreement``:
max-abs 2e-2 and each head's relative L2 within ``PAGED_REL_L2``, fused
pools byte-equal and the scratch page) and timed by
CUDA-graph replay, with the cluster size each takes.

``OLD.cu`` is a ``paged_attn.cu`` with the entry point that preceded the
SPLIT body (no ``split`` argument; for example ``git show
3759755:vcoder_tpu_torch/csrc/paged_attn.cu``), built with the same nvcc
command into a temporary directory; the wrappers launch it in place of this
tree's library. The A/B times every case in turns: the bases, this tree's
twice, the bases in reverse. ``--faults`` builds copies of this source with
one deliberate fault each (``FAULTS``, and ``TRAP_FAULTS``, which run in a
child process because a trap ends the process's CUDA context) and runs every
case through the checks: the sound kernel must pass everywhere and every
fault must fail somewhere (``BENIGN_FAULTS`` are run and reported too, but
no check can fail them: they change no byte that anything reads). ``--floor`` times a copy whose chunks are
replaced by one XOR of a K and a V word (``FLOOR``): the same ring, waits
and merges, so the kernel's time less the floor's is what the products,
the conversions and the softmax add. Exits non-zero when a check fails.
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

KERNEL = "paged_attn"

# SASS opcodes counted per kernel: int -> float conversions (I2F; the
# SPLIT body's only ones are the .RP forms of integer divisions' reciprocal,
# where the PAGE body converts int8 elements with I2F.S8 / I2F.S16), the
# int8 unpack (PRMT, FADD; HSUB2 of an f16 route), the products (FFMA),
# the reduce-scatter (SHFL), shared-memory loads, bulk copies (UBLKCP) and
# mbarrier operations (SYNCS).
SASS_OPS = ("I2F", "PRMT", "FADD", "HSUB2", "FFMA", "SHFL", "LDS", "UBLKCP", "SYNCS")
_FUNC = re.compile(r"Function : (\S+)")
_KERNEL = re.compile(r"(paged_attn_split|paged_attn_kernel)ILi(\d+)ELb([01])ELb([01])E")

# One fault per entry: (a line of paged_attn.cu, its broken form).
FAULTS = {
    "rank merge without the exp(m_s - m) rescale": (
        "        const float f = expf(mr[r] - M);",
        "        const float f = 1.f;"),
    "each split drops its last page": (
        "  const int p1 = static_cast<int>((long long)(rank + 1) * n_live / S);",
        "  const int p1 = max(p0, static_cast<int>((long long)(rank + 1) * n_live / S) - 1);"),
    "the window's keys in every rank": (
        "    if (FUSED && rank == S - 1) {",
        "    if (FUSED) {"),
    "the v-scale dropped": (
        "  if (Q8) pv = seen ? p * vsb[key * ss] : 0.f;",
        "  if (Q8) pv = seen ? p : 0.f;"),
}
# Faults no check can see, run and reported but not counted: every rank
# stores the same bytes into slots that no rank reads as keys (positions >=
# old), so outputs and pools are those of the sound kernel; the cost is
# duplicate stores only.
BENIGN_FAULTS = {
    "the writer in every rank": (
        "    } else if (FUSED && rank == 0) {",
        "    } else if (FUSED) {"),
}
# Faults that may trap (a lost mbarrier arrival): run in a child process.
TRAP_FAULTS = {
    "a ring stage's parity flipped (the producer's wait)": (
        "        if (it >= R) sm90::mbar_wait(bar0 + 8 * (R + s), ((it / R) - 1) & 1);",
        "        if (it >= R) sm90::mbar_wait(bar0 + 8 * (R + s), (it / R) & 1);"),
}

# The floor: each chunk of a tile replaced by one XOR of a K and a V word,
# so the ring's bytes are still waited for (the results are wrong by design,
# and not checked).
FLOOR = (
    "          chunk<NC, Q8, false>(kt + i * HD, vt + i * HD, HD, kst + i, vst + i, 1, L::KC,\n"
    "                               tok + i, lim, lim_max, qv, acc, m, l, pbuf, abuf, scale, lane);",
    "          acc[0][0] += __uint_as_float((*reinterpret_cast<const uint32_t*>(kt + i * HD) ^ "
    "*reinterpret_cast<const uint32_t*>(vt + i * HD)) & 0x3f800000u);")

# The C signature of the entry point before the SPLIT body (no split).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
OLD_ARGTYPES = [_P] * 14 + [_I] * 7 + [_L] * 3 + [_F, _I, _I, _P]


def split_cases() -> list:
    """(kind, case keyword arguments) of every phase-3 and phase-9 case that
    takes the SPLIT body."""
    out = [("paged", kw) for kw, _ in cs.PAGED_CASES
           if kw.get("quant") and kw["window"] * kw["H"] // kw["KH"] <= 16]
    return out + [("fused", kw) for kw in cs.FUSED_CASES]


def make_case(kind: str, kw: dict) -> dict:
    return cs._paged_case(**kw) if kind == "paged" else cs._fused_case(**kw)


def agreement(kind: str, case: dict) -> dict:
    return cs.paged_agreement(case) if kind == "paged" else cs.fused_agreement(case)


def run_of(kind: str, case: dict):
    """The kernel's call on ``case`` through the wrappers."""
    if kind == "paged":
        return cs.paged_runs(case)[0]
    fused, pools, layer = cs.fused_call(case), cs._pool_list(case), case["layer"]
    return lambda: fused(pools, layer)


def sass_counts(lib: Path) -> dict:
    """Per kernel of a library, e.g. ``split NC=4 q8=1 fused=0``: counts of
    ``SASS_OPS`` and the I2F forms it holds."""
    out = {}
    parts = _FUNC.split(_ab.sass(lib))
    for name, body in zip(parts[1::2], parts[2::2]):
        label = _kernel_label(name)
        if label is None:
            continue
        counts = {op: len(re.findall(r"\b" + op + r"\b", body)) for op in SASS_OPS}
        counts["I2F forms"] = sorted(set(re.findall(r"\bI2F[.A-Z0-9]*", body)))
        out[label] = counts
    return out


def _kernel_label(name: str):
    """``split NC=4 q8=1 fused=0`` for a mangled kernel name, else None."""
    m = _KERNEL.search(name)
    if m is None:
        return None
    body_name = "split" if m.group(1).endswith("split") else "page"
    return f"{body_name} NC={m.group(2)} q8={m.group(3)} fused={m.group(4)}"


def _log_build(label: str, text: str) -> None:
    """ptxas's registers, stack and spills, one line per kernel, and its
    errors and warnings."""
    kernel = ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_label(line) or line.split("'")[1][:40]
        elif any(w in line for w in ("registers", "spill", "error", "warning")):
            cs.log(f"  ptxas[{label}] {kernel}: {line.strip()}")


class _Base:
    """A base library behind this tree's signature: the wrappers' ``split``
    argument is dropped, the capacity asked of this tree's library."""

    def __init__(self, cdll, current):
        self._cdll, self._current, self._name = cdll, current, cdll._name

    def paged_attn(self, *args):
        return self._cdll.paged_attn(*args[:-2], args[-1])

    def __getattr__(self, name):
        return getattr(self._current, name)


def finish_variants(procs: dict) -> dict:
    """Waits for the builds of ``_ab.start_variants``; returns {label:
    library} (a base, whose label holds "#", behind :class:`_Base`)."""
    from vcoder_tpu_torch.ops import _kernels

    return _ab.finish_variants(KERNEL, procs, _log_build, old_argtypes=OLD_ARGTYPES,
                               wrap_base=lambda cdll: _Base(cdll, _kernels.lib(KERNEL)))


substituted = functools.partial(_ab.substituted, KERNEL)  # (subs) -> this tree's source
library = functools.partial(_ab.library, KERNEL)  # with library(cdll): ...


def ab(libs: dict) -> dict:
    """Every case, each base against this tree's kernel, in turns."""
    import torch

    out = {}
    names = list(libs)
    for kind, kw in split_cases():
        case = make_case(kind, kw)
        run = run_of(kind, case)
        for n in names:
            with library(libs[n]):
                agree = agreement(kind, case)
            cs.log(f"A/B {kw['name']}: {n} against the plain version {json.dumps(agree)}")
        times: dict = {n: [] for n in names + ["new"]}
        for which in names + ["new", "new"] + names[::-1]:
            with library(None if which == "new" else libs[which]):
                times[which].append(round(cs.graph_ms([run] * 5), 5))
        out[kw["name"]] = times
        faster = all(max(times["new"]) < min(times[n]) for n in names)
        cs.log(f"A/B {kw['name']}: " + "  ".join(f"{n} {times[n]} ms" for n in names + ["new"])
               + f"  -> this tree faster in every turn: {faster}")
        del case, run
        torch.cuda.empty_cache()
    return out


def floor(cdll) -> dict:
    """Per-call ms of the floor build at every case."""
    import torch

    out = {}
    with library(cdll):
        for kind, kw in split_cases():
            case = make_case(kind, kw)
            out[kw["name"]] = round(cs.graph_ms([run_of(kind, case)] * 5), 5)
            del case
            torch.cuda.empty_cache()
    cs.log(f"floor (ring, waits and merges; no products), ms: {json.dumps(out)}")
    return out


def fault_checks(libs: dict) -> dict:
    """Every case through the checks with each library (None: this tree's).
    Returns {label: True when some check failed}."""
    import torch

    failed: dict = {}
    for kind, kw in split_cases():
        case = make_case(kind, kw)
        for name, cdll in libs.items():
            with library(cdll):
                try:
                    agree = agreement(kind, case)
                except RuntimeError as e:  # a refused launch fails the check too
                    agree = dict(ok=False, error=str(e))
            torch.cuda.synchronize()
            cs.log(f"faults {kw['name']} [{name}]: {json.dumps(agree)}")
            failed[name] = failed.get(name, False) or not agree["ok"]
        del case
        torch.cuda.empty_cache()
    return failed


def trap_child(so: str) -> int:
    """Child mode: every case with the library at ``so``; exit 0 when all
    pass, 1 when a check fails (a trap raises, exit 1 too)."""
    from vcoder_tpu_torch.ops import _kernels

    failed = fault_checks({"variant": _kernels.load("paged_attn", Path(so))})
    return 1 if failed["variant"] else 0


def faults(libs: dict, trap_libs: dict, benign_libs: dict) -> bool:
    """The sound kernel and each fault through every case; the trap faults
    in a child process each. True when the sound kernel passes everywhere
    and each fault but the benign ones fails somewhere."""
    failed = fault_checks({"sound": None, **libs, **benign_libs})
    for name, cdll in trap_libs.items():
        cmd = [sys.executable, __file__, "--trap-child", cdll._name]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
            failed[name] = proc.returncode != 0
            cs.log(f"faults [{name}]: child exit {proc.returncode}; {' | '.join(tail)}")
        except subprocess.TimeoutExpired:
            failed[name] = True
            cs.log(f"faults [{name}]: child ran past 300 s (a hang, not a trap)")
    sound_failed = failed.pop("sound")
    benign = {k: failed.pop(k) for k in benign_libs}
    cs.log(f"faults: sound {'FAILED' if sound_failed else 'passed'} everywhere; "
           + json.dumps({k: ("caught" if v else "NOT caught") for k, v in failed.items()})
           + "; benign, not counted: "
           + json.dumps({k: ("caught" if v else "not caught") for k, v in benign.items()}))
    return not sound_failed and all(failed.values())


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, action="append", default=[],
                    help="a paged_attn.cu with the entry point before the SPLIT body "
                         "(repeatable)")
    ap.add_argument("--faults", action="store_true", help="build and run the broken variants")
    ap.add_argument("--floor", action="store_true", help="time the body without its products")
    ap.add_argument("--trap-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_attn_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.trap_child:
        return trap_child(args.trap_child)
    from vcoder_tpu_torch.ops import _kernels
    from vcoder_tpu_torch.ops import paged_attention as pa

    cs.phase_device()
    with tempfile.TemporaryDirectory(prefix="paged_attn_ab_") as tmp:
        # Every build at once: this tree's source, the bases, the faults.
        sources = {f"{p.name}#{i}": p.read_text() for i, p in enumerate(args.base)}
        if args.faults:
            sources.update({label: substituted([sub]) for label, sub in FAULTS.items()})
            sources.update({label: substituted([sub]) for label, sub in TRAP_FAULTS.items()})
            sources.update({label: substituted([sub]) for label, sub in BENIGN_FAULTS.items()})
        if args.floor:
            sources["floor"] = substituted([FLOOR])
        procs = _ab.start_variants(sources, Path(tmp))
        secs = _kernels.build(["paged_attn"])
        cs.log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
        _log_build("paged_attn", _kernels.BUILD_LOG.get("paged_attn", ""))
        libs = finish_variants(procs)
        counts = sass_counts(_kernels._lib_path("paged_attn"))
        for label, c in counts.items():
            cs.log(f"sass {label}: {json.dumps(c)}")
        # No int -> float conversion in the SPLIT body but integer divisions'.
        split_forms = {f for k, c in counts.items() if k.startswith("split")
                       for f in c["I2F forms"]}
        ok = (any(k.startswith("split") for k in counts)
              and all(f.endswith(".RP") for f in split_forms))
        cs.log(f"sass: the SPLIT body's I2F forms {sorted(split_forms)} -> "
               f"{'only integer divisions' if ok else 'FAIL: an element conversion'}")
        dev = torch.cuda.current_device()
        for quant, fused, C in ((1, 0, 1), (1, 0, 4), (1, 0, 16), (0, 1, 1), (0, 1, 4)):
            cs.log(f"blocks one wave holds, clusters of 1..8 (quant {quant}, fused {fused}, "
                   f"C {C}): {pa._capacity(dev, quant, fused, C)}")
        report: list = []
        for kind, kw in split_cases():
            case = make_case(kind, kw)
            if kind == "paged":
                cs.check_paged(case, report)
            else:
                case["report"] = False
                cs.check_fused(case, report)
            del case
            torch.cuda.empty_cache()
        if args.base:
            ab({n: libs[n] for n in libs if "#" in n})
        if args.floor:
            floor(libs["floor"])
        if args.faults:
            ok = faults({n: libs[n] for n in FAULTS}, {n: libs[n] for n in TRAP_FAULTS},
                        {n: libs[n] for n in BENIGN_FAULTS}) and ok
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
           "--format=csv,noheader"]
    cs.log(f"card after the runs: {subprocess.run(smi, capture_output=True, text=True).stdout.strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
