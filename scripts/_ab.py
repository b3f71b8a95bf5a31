"""What the kernels' A/B scripts (``scripts/*_ab.py``) share: building
variants of one kernel's source in parallel, loading them, and swapping
the library that the wrappers launch.

A variant's label that holds "#" is a base: a source with an earlier C
entry point, loaded with the argument types it had (``old_argtypes``) and
optionally wrapped to take this tree's arguments.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
from pathlib import Path


def sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def substituted(kernel: str, subs: list) -> str:
    """This tree's ``csrc/<kernel>.cu`` with each (old, new) of ``subs``
    replaced; each old must occur exactly once."""
    from vcoder_tpu_torch.ops import _kernels

    src = (_kernels.SRC_DIR / f"{kernel}.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"{old!r} is not in {kernel}.cu exactly once")
        src = src.replace(old, new)
    return src


def start_variants(sources: dict, tmp: Path) -> dict:
    """Starts one nvcc per {label: source text}, into ``tmp``; returns
    {label: (process, library path)} for :func:`finish_variants`."""
    from vcoder_tpu_torch.ops import _kernels

    procs = {}
    for i, (label, text) in enumerate(sources.items()):
        cu, so = tmp / f"variant{i}.cu", tmp / f"libvariant{i}.so"
        cu.write_text(text)
        procs[label] = (subprocess.Popen(_kernels.nvcc_command(cu, so), stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), so)
    return procs


def finish_variants(kernel: str, procs: dict, log_build, *, old_argtypes=None,
                    wrap_base=None) -> dict:
    """Waits for the builds of :func:`start_variants`, passing each one's
    compiler output to ``log_build(label, text)``; returns {label:
    library}. With ``old_argtypes``, a base (label with "#") is loaded with
    them for its ``kernel`` function and handed to ``wrap_base`` when given;
    every other variant is loaded with this tree's signatures."""
    from vcoder_tpu_torch.ops import _kernels

    libs = {}
    for label, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {label!r}:\n{text}")
        log_build(label, text)
        if "#" in label and old_argtypes is not None:
            cdll = ctypes.CDLL(str(so))
            fn = getattr(cdll, kernel)
            fn.argtypes = old_argtypes
            fn.restype = ctypes.c_int
            libs[label] = wrap_base(cdll) if wrap_base else cdll
        else:
            libs[label] = _kernels.load(kernel, so)
    return libs


@contextlib.contextmanager
def library(kernel: str, cdll):
    """The wrappers launch ``cdll`` (another build of ``kernel``) inside the
    block; None keeps this tree's."""
    from vcoder_tpu_torch.ops import _kernels

    real = _kernels.lib(kernel)
    if cdll is not None:
        _kernels._LIBS[kernel] = cdll
    try:
        yield
    finally:
        _kernels._LIBS[kernel] = real
