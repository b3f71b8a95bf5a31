"""Build and load the hand-written CUDA kernels of ``vcoder_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into ``vcoder_tpu_torch/_build/lib<name>-<hash>.so`` (the hash
is of the source, so a stale library is never loaded). The library is loaded
with ``ctypes``; every pointer and the stream pass as ``c_void_p`` so ctypes
never cuts them to 32 bits. Nothing is built at import time: the first call
that needs a kernel builds it, and :func:`build` builds several sources in
parallel (one ``nvcc`` process each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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

# C signatures of the entry points (all return the launch's cudaError_t).
_SIGNATURES = {
    "flash_fwd": (
        "flash_fwd",
        [_P, _P, _P, _P, _P, _P, _P]  # q k v qpos kvmask o lse
        + [_I] * 6  # B T S H KH D
        + [_L] * 9  # q/k/v batch, token, head strides
        + [_F, _I, _P],  # scale causal stream
    ),
    "gemm_bias": ("gemm_bias", [_P, _P, _P, _P, _I, _I, _I, _P]),
    "paged_attn": (
        "paged_attn",
        [_P] * 8  # q kp vp ks vs table lengths out
        + [_I] * 7  # B window H KH n_pages page P_max
        + [_L] * 3  # q batch, token, head strides
        + [_F, _I, _P],  # scale quant stream
    ),
    "int4_matmul": (
        "int4_matmul",
        [_P] * 4  # x qp part out
        + [_I] * 3  # B K2 N
        + [_L]  # x row stride
        + [_I] * 3  # splits rows_per_split out_f32
        + [_P],  # stream
    ),
    "int8_mm": (
        "int8_mm",
        [_P] * 5  # A B sa sb C
        + [_I] * 5  # M N K scaled out_kind
        + [_P],  # stream
    ),
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


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


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
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(SRC_DIR / f"{name}.cu"),
        ]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
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


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build([name])
        cdll = ctypes.CDLL(str(_lib_path(name)))
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(cdll, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = cdll
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
