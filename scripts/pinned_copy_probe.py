#!/usr/bin/env python3
"""Host-side limits that the optimizer-state offload meets on one GPU: the
pinned-memory copy rates, host memory and disk.

    python3 scripts/pinned_copy_probe.py

Prints the card's name and power limit (``nvidia-smi``), the Python, torch
and CUDA versions, the total and free space of the temporary directory's
and this checkout's disks, the host's ``/proc/meminfo`` head, then for 1 and
4 GiB of bf16: the time to make pinned zeros, whether a slice of a pinned
tensor reports pinned, the rate of a ``non_blocking`` H2D copy and of a D2H
copy (the mean of 3 after one warm-up, host clock around
``torch.cuda.synchronize``), and both at once on two streams; last, the
time to write 4 GiB to the temporary directory with an ``fsync``.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch


def rss() -> str:
    with open("/proc/self/status") as f:
        return next(line.strip() for line in f if line.startswith("VmRSS"))


def main() -> int:
    if not torch.cuda.is_available():
        print("pinned_copy_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(sys.version, torch.__version__, torch.version.cuda)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for p in (tempfile.gettempdir(), here):
        u = shutil.disk_usage(p)
        print(f"disk {p}: {u.total / 2**30:.1f} GiB total, {u.free / 2**30:.1f} GiB free")
    with open("/proc/meminfo") as f:
        print(f.read()[:400])
    for gib in (1, 4):
        t0 = time.perf_counter()
        h = torch.zeros(gib << 29, dtype=torch.bfloat16, pin_memory=True)
        print(f"pinned zeros {gib} GiB: {time.perf_counter() - t0:.3f} s, is_pinned "
              f"{h.is_pinned()}, slice pinned {h[10:100].is_pinned()}, {rss()}")
        d = torch.empty_like(h, device="cuda")
        torch.cuda.synchronize()
        for name, fn in (("H2D", lambda: d.copy_(h, non_blocking=True)),
                         ("D2H", lambda: h.copy_(d, non_blocking=True))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / 3
            print(f"  {name} {gib} GiB: {dt * 1e3:.1f} ms, {h.numel() * 2 / dt / 1e9:.1f} GB/s")
        h2 = torch.empty_like(h, pin_memory=True)
        d2 = torch.empty_like(d)
        s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(s1):
            d.copy_(h, non_blocking=True)
        with torch.cuda.stream(s2):
            h2.copy_(d2, non_blocking=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"  both ways, {gib} GiB each: {dt * 1e3:.1f} ms, "
              f"{2 * h.numel() * 2 / dt / 1e9:.1f} GB/s in all")
        del h, d, h2, d2
    d = tempfile.mkdtemp()
    try:
        buf = os.urandom(1 << 26)
        t0 = time.perf_counter()
        with open(os.path.join(d, "x"), "wb") as f:
            for _ in range(64):
                f.write(buf)
            f.flush()
            os.fsync(f.fileno())
        print(f"write 4 GiB to {d}: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
