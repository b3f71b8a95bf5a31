#!/usr/bin/env python3
"""The paged attention kernel (``vcoder_tpu_torch/csrc/paged_attn.cu``: the
SPLIT body for calls of C <= 16 query columns, the TILE body past them) on
one GPU: its build report, its SASS, every paged and fused case of
``chip_smoke.py``'s phases 3 and 9, and A/Bs on the same card.

    python3 scripts/paged_attn_ab.py                 # build, SASS, every case
    python3 scripts/paged_attn_ab.py --base OLD.cu   # ... and an A/B (--base repeats)
    python3 scripts/paged_attn_ab.py --faults        # ... and the broken variants
    python3 scripts/paged_attn_ab.py --floor         # ... and both bodies without their products
    python3 scripts/paged_attn_ab.py --base OLD.cu --engines   # ... and engines A and C

The cases are every ``chip_smoke.PAGED_CASES`` and ``chip_smoke.FUSED_CASES``
case, each checked against the plain version (``paged_agreement`` /
``fused_agreement``: max-abs 2e-2 and each head's relative L2 within
``PAGED_REL_L2``, fused pools byte-equal and the scratch page) and timed by
CUDA-graph replay, with the body and cluster size each takes.

``OLD.cu`` is a ``paged_attn.cu`` with the entry point that preceded the
TILE body (one ``split`` argument: 0 for the earlier PAGE body, else the SPLIT
body's cluster size, which that source took for int8 and fused calls only;
for example ``git show 3abd4b5:vcoder_tpu_torch/csrc/paged_attn.cu``),
built with the same nvcc command into a temporary directory; the wrappers
launch it in place of this tree's library, routed as that source's tree
routed (:class:`_Base`). The A/B times every case in turns: the bases, this
tree's twice, the bases in reverse. ``--engines`` (with one base) serves
``chip_smoke.py``'s engines A and C on VCoder-DS-7B's seeded weights with
the base's library and with this tree's, logging each engine's token digest,
and engine C's first turn (chunked prefill, verify windows) under
``torch.profiler`` in turns (base, this tree, this tree, base): the paged
kernels' device time by name, launches by window, TTFT.

``--faults`` builds copies of this source with one deliberate fault each
(``FAULTS``, and ``TRAP_FAULTS``, which run in a child process because a
trap ends the process's CUDA context) and runs every case through the
checks: the sound kernel must pass everywhere and every fault must fail
somewhere (``BENIGN_FAULTS`` are run and reported too, but the checks
cannot fail them: see each entry). ``--floor`` times copies whose work is
cut to the loads (``FLOORS``): the same loads, waits and merges, so the
kernel's time less the floor's is what the products, the conversions and
the softmax add. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
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

KERNEL = "paged_attn"

# SASS opcodes counted per kernel: int -> float conversions (I2F; the
# bodies' only ones are the .RP forms of integer divisions' reciprocal), the
# int8 unpack (PRMT, FADD), CUDA-core products (FFMA), the SPLIT body's
# reduce-scatter (SHFL), shared-memory loads, bulk and tensor copies (UBLKCP,
# UTMALDG), mbarrier operations (SYNCS), the TILE body's tensor-core
# products (HGMMA), their waits (WARPGROUP.DEPBAR: one per commit group, or
# one per HGMMA when ptxas serialized them) and its exponentials (MUFU.EX2).
SASS_OPS = ("I2F", "PRMT", "FADD", "FFMA", "SHFL", "LDS", "UBLKCP", "UTMALDG", "SYNCS", "HGMMA",
            "WARPGROUP.DEPBAR", "MUFU.EX2")
_FUNC = re.compile(r"Function : (\S+)")
_SPLIT_KERNEL = re.compile(r"paged_attn_splitILi(\d+)ELb([01])ELb([01])E")
_TILE_KERNEL = re.compile(r"paged_attn_tileILb([01])ELb([01])E")

# One fault per entry: (a line of paged_attn.cu, its broken form). The
# SPLIT body's, then the TILE body's.
FAULTS = {
    "SPLIT: rank merge without the exp(m_s - m) rescale": (
        "        const float f = expf(mr[r] - M);",
        "        const float f = 1.f;"),
    "SPLIT: each split drops its last page": (
        "  const int p1 = static_cast<int>((long long)(rank + 1) * n_live / S);",
        "  const int p1 = max(p0, static_cast<int>((long long)(rank + 1) * n_live / S) - 1);"),
    "SPLIT: the window's keys in every rank": (
        "    if (FUSED && rank == S - 1) {",
        "    if (FUSED) {"),
    "SPLIT: the v-scale dropped": (
        "  if (Q8) pv = seen ? p * vsb[key * ss] : 0.f;",
        "  if (Q8) pv = seen ? p : 0.f;"),
    "TILE: the mask off by one (a column sees the next token)": (
        "    return !MASKED || base + 8 * c + 2 * t + (e & 1) <= lim[e >> 1];",
        "    return !MASKED || base + 8 * c + 2 * t + (e & 1) <= lim[e >> 1] + 1;"),
    # The last box of the last tile: at pages of 64 or less the row's last
    # live page (or its part in that tile), at longer pages its last 64 keys.
    "TILE: the last live page dropped": (
        "          const int nb = min(BK / box_rows, (pool_end - x0 + box_rows - 1) / box_rows);",
        "          const int nb = min(BK / box_rows, (pool_end - x0 + box_rows - 1) / box_rows) -\n"
        "                         (j == n_pool - 1 ? 1 : 0);"),
    "TILE: the k-scale dropped": (
        "      if (Q8) x *= sc[8 * c + 2 * t + (e & 1)];",
        "      if (Q8) x *= 1.f;"),
    "TILE: page ids not clipped": (
        "            pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);\n"
        "            const uint32_t r = i * box;",
        "            const uint32_t r = i * box;"),
}
# Faults no check can see, run and reported but not counted.
BENIGN_FAULTS = {
    # Every rank stores the same bytes into slots that no rank reads as
    # keys (positions >= old): outputs and pools are the sound kernel's.
    "SPLIT: the writer in every rank": (
        "    } else if (FUSED && rank == 0) {",
        "    } else if (FUSED) {"),
    # p rounded to bf16, then multiplied by the v-scale and rounded again:
    # one more bf16 rounding of p (2**-9 relative, averaged over a row's
    # keys), below the output's own bf16 rounding that the gates allow.
    "TILE: the v-scale applied after the bf16 rounding": (
        "        x *= sc[BK + 8 * c + 2 * t + (e & 1)];",
        "        x = __bfloat162float(__float2bfloat16(x)) * sc[BK + 8 * c + 2 * t + (e & 1)];"),
}
# Faults that may trap (a lost mbarrier arrival): run in a child process.
TRAP_FAULTS = {
    "SPLIT: a ring stage's parity flipped (the producer's wait)": (
        "        if (it >= R) sm90::mbar_wait(bar0 + 8 * (R + s), ((it / R) - 1) & 1);",
        "        if (it >= R) sm90::mbar_wait(bar0 + 8 * (R + s), (it / R) & 1);"),
}

# The floors: the SPLIT body's chunks replaced by one XOR of a K and a V
# word; the TILE body's consumers reduced to waiting for each tile and
# releasing it (its producer and, int8, its converters unchanged). The
# loads are still waited for; the results are wrong by design, and not
# checked.
FLOORS = [
    ("          chunk<NC, Q8, false>(kt + i * HD, vt + i * HD, HD, kst + i, vst + i, 1, L::KC,\n"
     "                               tok + i, lim, lim_max, qv, acc, m, l, pbuf, abuf, scale, lane);",
     "          acc[0][0] += __uint_as_float((*reinterpret_cast<const uint32_t*>(kt + i * HD) ^ "
     "*reinterpret_cast<const uint32_t*>(vt + i * HD)) & 0x3f800000u);"),
    ("  float acc[64];\n#pragma unroll\n  for (int i = 0; i < 64; ++i) acc[i] = 0.f;",
     "  for (int j = 0; j < n_tiles; ++j) {\n    mbar_wait(full(j % R), (j / R) & 1);\n"
     "    if (lane == 0) mbar_arrive(empty(j % R));\n  }\n  if (n_tiles >= 0) return;\n"
     "  float acc[64];\n#pragma unroll\n  for (int i = 0; i < 64; ++i) acc[i] = 0.f;"),
]

# The C signature of the entry point before the TILE body (one split).
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
OLD_ARGTYPES = [_P] * 14 + [_I] * 7 + [_L] * 3 + [_F, _I, _I, _I, _P]


def all_cases() -> list:
    """(kind, case keyword arguments) of every phase-3 and phase-9 case."""
    return ([("paged", kw) for kw, _ in cs.PAGED_CASES]
            + [("fused", kw) for kw in cs.FUSED_CASES])


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
    """Per kernel of a library, e.g. ``split NC=4 q8=1 fused=0`` or ``tile
    q8=1 fused=0``: counts of ``SASS_OPS`` and the I2F forms it holds."""
    out = {}
    parts = _FUNC.split(_ab.sass(lib))
    for name, body in zip(parts[1::2], parts[2::2]):
        label = _kernel_label(name)
        if label is None:
            continue
        counts = {op: len(re.findall(r"\b" + re.escape(op) + r"\b", body)) for op in SASS_OPS}
        counts["I2F forms"] = sorted(set(re.findall(r"\bI2F[.A-Z0-9]*", body)))
        out[label] = counts
    return out


def sass_bodies(lib: Path) -> dict:
    """Per kernel label of a library: its SASS instructions without
    addresses and encodings, to compare two builds of the same code."""
    out = {}
    parts = _FUNC.split(_ab.sass(lib))
    for name, body in zip(parts[1::2], parts[2::2]):
        label = _kernel_label(name)
        if label is not None:
            lines = (re.sub(r"/\*[^*]*\*/", "", line).strip() for line in body.splitlines())
            out[label] = "\n".join(line for line in lines if line)
    return out


def _kernel_label(name: str):
    """``split NC=4 q8=1 fused=0`` / ``tile q8=1 fused=0`` for a mangled
    kernel name, else None."""
    m = _SPLIT_KERNEL.search(name)
    if m is not None:
        return f"split NC={m.group(1)} q8={m.group(2)} fused={m.group(3)}"
    m = _TILE_KERNEL.search(name)
    if m is not None:
        return f"tile q8={m.group(1)} fused={m.group(2)}"
    return None


def _log_build(label: str, text: str) -> None:
    """ptxas's registers, stack and spills, one line per kernel, its notes
    on serialized wgmma, and its errors and warnings."""
    kernel = ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_label(line) or line.split("'")[1][:40]
        elif any(w in line for w in ("registers", "spill", "error", "warning", "serialized",
                                     "Performance")):
            cs.log(f"  ptxas[{label}] {kernel}: {line.strip()}")


class _Base:
    """A base library behind this tree's signature, routed as its own tree
    routed: its SPLIT body took int8 and fused calls of C <= 16, its PAGE
    body (``split`` 0) everything else. The capacity is asked of this
    tree's library."""

    def __init__(self, cdll, current):
        self._cdll, self._current, self._name = cdll, current, cdll._name

    def paged_attn(self, *args):
        from vcoder_tpu_torch.ops import paged_attention as pa

        quant, fused, body, cluster, stream = args[-5:]
        split = cluster if body == pa.BODY_SPLIT and (quant or fused) else 0
        return self._cdll.paged_attn(*args[:-3], split, stream)

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
    for kind, kw in all_cases():
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
        slower = [n for n in names if all(t > max(times[n]) for t in times["new"])]
        cs.log(f"A/B {kw['name']}: " + "  ".join(f"{n} {times[n]} ms" for n in names + ["new"])
               + f"  -> this tree faster in every turn: {faster}; slower in every turn than: "
               + json.dumps(slower))
        del case, run
        torch.cuda.empty_cache()
    return out


def floor(cdll) -> dict:
    """Per-call ms of the floor build at every case."""
    import torch

    out = {}
    with library(cdll):
        for kind, kw in all_cases():
            case = make_case(kind, kw)
            out[kw["name"]] = round(cs.graph_ms([run_of(kind, case)] * 5), 5)
            del case
            torch.cuda.empty_cache()
    cs.log(f"floor (loads, waits and merges; no products), ms: {json.dumps(out)}")
    return out


def fault_checks(libs: dict) -> dict:
    """Every case through the checks with each library (None: this tree's).
    Returns {label: True when some check failed}."""
    import torch

    failed: dict = {}
    for kind, kw in all_cases():
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


def engines(base) -> None:
    """Engines A and C of ``chip_smoke.phase_engines`` with the base's
    library and with this tree's: each engine's token digest, then engine
    C's first turn under the profiler in turns (base, this tree, this tree,
    base)."""
    import numpy as np

    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token

    cfg, params, _, tok = cs.build_model()
    rng = np.random.RandomState(11)
    ids = tokenizer_depth_seg_token(cs.PROMPT, tok)
    preps = [cs._prepared(ids, cs._images(rng, h, w), 32)[0] for h, w in cs.ENGINE_SIZES]
    for which, cdll in (("base", base), ("new", None)):
        with library(cdll):
            cs.log(f"engines with the {which} library:")
            cs._run_engine(f"A [{which}]", cfg, params, [preps], max_new=32)
            cs._run_engine(f"C [{which}]", cfg, params,
                           [preps[:4], cs.engine_c_turn2(preps, tok)], max_new=32,
                           **cs.ENGINE_C)
    for which, cdll in (("base", base), ("new", None), ("new", None), ("base", base)):
        with library(cdll):
            cs.profile_engine_chunks(cfg, params, preps, tag=f"profile_engine_chunks [{which}]")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=Path, action="append", default=[],
                    help="a paged_attn.cu with the entry point before the TILE body "
                         "(repeatable)")
    ap.add_argument("--faults", action="store_true", help="build and run the broken variants")
    ap.add_argument("--floor", action="store_true", help="time the bodies without their products")
    ap.add_argument("--engines", action="store_true",
                    help="engines A and C with the (first) base and with this tree")
    ap.add_argument("--trap-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_attn_ab: CUDA is not available", file=sys.stderr)
        return 2
    if args.trap_child:
        return trap_child(args.trap_child)
    if args.engines and not args.base:
        ap.error("--engines needs --base")
    from vcoder_tpu_torch.ops import _kernels
    from vcoder_tpu_torch.ops import paged_attention as pa

    cs.phase_device()
    with tempfile.TemporaryDirectory(prefix="paged_attn_ab_") as tmp:
        # Every build at once: this tree's source, the bases, the faults.
        sources = {f"{p.name}#{i}": p.read_text() for i, p in enumerate(args.base)}
        if args.faults:
            for group in (FAULTS, TRAP_FAULTS, BENIGN_FAULTS):
                sources.update({label: substituted([sub]) for label, sub in group.items()})
        if args.floor:
            sources["floor"] = substituted(FLOORS)
        procs = _ab.start_variants(sources, Path(tmp))
        secs = _kernels.build(["paged_attn"])
        cs.log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})}")
        _log_build("paged_attn", _kernels.BUILD_LOG.get("paged_attn", ""))
        libs = finish_variants(procs)
        counts = sass_counts(_kernels._lib_path("paged_attn"))
        for label, c in counts.items():
            cs.log(f"sass {label}: {json.dumps(c)}")
        # No int -> float conversion but integer divisions'; the TILE
        # body's products on tensor cores, waited for once per commit group.
        forms = {f for c in counts.values() for f in c["I2F forms"]}
        tiles = {k: c for k, c in counts.items() if k.startswith("tile")}
        ok = (any(k.startswith("split") for k in counts) and len(tiles) == 4
              and all(f.endswith(".RP") for f in forms)
              and all(c["HGMMA"] > 0 and c["WARPGROUP.DEPBAR"] < c["HGMMA"] for c in tiles.values()))
        cs.log(f"sass: I2F forms {sorted(forms)}; TILE kernels with HGMMA, not one wait per "
               f"HGMMA -> {'ok' if ok else 'FAIL'}")
        # The SPLIT kernels a base shares with this tree, compared as code.
        mine = sass_bodies(_kernels._lib_path("paged_attn"))
        for n, base in ((n, lib) for n, lib in libs.items() if "#" in n):
            theirs = sass_bodies(Path(base._name))
            shared = sorted(k for k in mine if k in theirs)
            same = [k for k in shared if mine[k] == theirs[k]]
            cs.log(f"sass: kernels of {n} with this tree's SASS: {len(same)} of {len(shared)} "
                   f"shared; differing {json.dumps(sorted(set(shared) - set(same)))}")
        dev = torch.cuda.current_device()
        for quant, fused, C in ((0, 0, 1), (0, 0, 4), (1, 0, 1), (1, 0, 4), (1, 0, 16), (0, 1, 1),
                                (0, 1, 4)):
            cs.log(f"blocks one wave holds, clusters of 1..8 (quant {quant}, fused {fused}, "
                   f"C {C}): {pa._capacity(dev, quant, fused, C)}")
        report: list = []
        for kind, kw in all_cases():
            case = make_case(kind, kw)
            if kind == "paged":
                cs.check_paged(case, report)
            else:
                case["report"] = False
                cs.check_fused(case, report)
            del case
            torch.cuda.empty_cache()
        bases = {n: libs[n] for n in libs if "#" in n}
        if bases:
            ab(bases)
        if args.floor:
            floor(libs["floor"])
        if args.faults:
            ok = faults({n: libs[n] for n in FAULTS}, {n: libs[n] for n in TRAP_FAULTS},
                        {n: libs[n] for n in BENIGN_FAULTS}) and ok
        if args.engines:
            engines(next(iter(bases.values())))
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
           "--format=csv,noheader"]
    cs.log(f"card after the runs: {subprocess.run(smi, capture_output=True, text=True).stdout.strip()}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
