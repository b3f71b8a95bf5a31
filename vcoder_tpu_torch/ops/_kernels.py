"""Build and load the hand-written CUDA kernels of ``vcoder_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into ``vcoder_tpu_torch/_build/lib<name>-<hash>.so`` (the hash
is of the source and of the ``csrc`` headers it includes, so a stale library
is never loaded). The library is loaded with ``ctypes``; every pointer and
the stream pass as ``c_void_p`` so ctypes never cuts them to 32 bits. Nothing is built at import time: the first call
that needs a kernel builds it, and :func:`build` builds several sources in
parallel (one ``nvcc`` process each). A wrapper whose kernel has no backward
calls :func:`forbid_grad` before launching, so autograd never records an
output without a ``grad_fn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of each library's entry points (all return a cudaError_t).
_SIGNATURES = {
    "flash_fwd": {
        "flash_fwd": [_P, _P, _P, _P, _P, _P, _P]  # q k v qpos kvmask o lse
        + [_I] * 6  # B T S H KH D
        + [_L] * 9  # q/k/v batch, token, head strides
        + [_F, _I, _P],  # scale causal stream
    },
    "flash_bwd": {
        # q k v out dout lse delta qs qpos kvmask dq dk dv (delta, qs: scratch)
        "flash_bwd": [_P] * 13
        + [_I] * 6  # B T S H KH D
        + [_L] * 15  # q/k/v/out/dout batch, token, head strides
        + [_F, _I, _P],  # scale causal stream
    },
    "gemm_bias": {"gemm_bias": [_P] * 4 + [_I] * 3 + [_P]},  # A W bias C M N K stream
    "vit_mlp": {
        "vit_mlp_ln": [_P] * 4 + [_I, _I, _F, _I, _P],  # x s b h M Dm eps vec_bf16 stream
        # A W bias bias_bf16 R C M N K epi stream
        "vit_mlp_gemm": [_P] * 3 + [_I] + [_P] * 2 + [_I] * 4 + [_P],
    },
    "paged_attn": {
        "paged_attn": [_P] * 8  # q kp vp ks vs table lengths out
        + [_P] * 6  # fused: nk nv nks nvs positions active
        + [_I] * 7  # B window H KH n_pages page P_max
        + [_L] * 3  # q batch, token, head strides
        + [_F, _I, _I, _I, _I, _P],  # scale quant fused body cluster stream
        "paged_attn_capacity": [_I] * 3 + [_P],  # quant fused C blocks[8]
    },
    "int4_matmul": {
        "int4_matmul": [_P] * 4  # x qp scale out
        + [_I] * 3  # B K2 N
        + [_L]  # x row stride
        + [_I] * 2  # cluster out_kind
        + [_P],  # stream
        "int4_matmul_capacity": [_P],  # blocks[8]
    },
    "int8_mm": {
        "int8_mm": [_P] * 5  # A B sa sb C
        + [_I] * 5  # M N K scaled out_kind
        + [_P],  # stream
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's report (registers, shared memory, spills) and seconds per source.
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: Path) -> list:
    """``src`` and every file of its directory that it includes with
    ``#include "..."``, directly or through another such file."""
    seen, todo = [], [src]
    while todo:
        p = todo.pop()
        if p in seen or not p.exists():
            continue
        seen.append(p)
        todo += [src.parent / m.decode() for m in _INCLUDE.findall(p.read_bytes())]
    return seen


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of the headers it includes, so a stale library is never loaded."""
    h = hashlib.sha1()
    for p in _sources(SRC_DIR / f"{name}.cu"):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(src: Path, out: Path) -> list:
    """The nvcc command line that builds ``src`` into the library ``out``;
    a copy of a source outside ``csrc`` still finds the ``csrc`` headers."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", str(SRC_DIR), "-o", str(out), str(src),
    ]


def build(names: Iterable[str] = tuple(_SIGNATURES)) -> Dict[str, float]:
    """Compile the named sources that are not built yet, all at once.
    Returns the wall seconds of each compile that ran; raises with nvcc's
    output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                nvcc_command(SRC_DIR / f"{name}.cu", tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out, time.perf_counter(),
        )
    seconds = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        BUILD_SECONDS[name] = seconds[name]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    return seconds


def load(name: str, path: Path) -> ctypes.CDLL:
    """The library at ``path``, built from a source with ``csrc/<name>.cu``'s
    entry points, with their C signatures set."""
    cdll = ctypes.CDLL(str(path))
    for sym, argtypes in _SIGNATURES[name].items():
        fn = getattr(cdll, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return cdll


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = load(name, _lib_path(name))
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def needs_grad(*tensors) -> bool:
    """True when autograd would record a graph through these tensors: grad
    mode is on and one of them requires grad."""
    import torch

    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    )


def forbid_grad(what: str, *tensors) -> None:
    """Raise before launching a kernel that has no backward (as in the JAX
    package, which has none for it) on inputs autograd would differentiate:
    its output would carry no ``grad_fn`` and cut the gradient silently."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: this kernel has no backward; call it under torch.no_grad() "
            "or on inputs that do not require grad"
        )


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
