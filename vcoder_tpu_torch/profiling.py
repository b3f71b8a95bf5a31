"""Tracing and host-side step timing (port of ``vcoder_tpu/profiling.py``).

* :func:`trace` -- context manager around ``torch.profiler`` that writes a
  Chrome trace (host ops, and CUDA kernels and copies on a card) under a
  directory; the JAX package writes ``jax.profiler``'s TensorBoard trace.
* :func:`annotate` -- a named region visible in the trace
  (``torch.profiler.record_function``).
* :func:`maybe_trace` -- :func:`trace` iff ``VCODER_TPU_TRACE`` (or a
  default directory) is set.
* :class:`StepTimer` -- named host-clock samples with percentile summaries.
  The serving engine records ``ttft``, ``decode_step``, ``admit_stage`` and
  ``admit_chunk``. A sample ends where the caller returns, which on CUDA is
  after the step's host synchronisation (the engine reads its tokens back).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False):
    """Profile the enclosed block and write ``trace-<pid>-<ns>.json`` (Chrome
    trace format) under ``logdir``, also when the block raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if create_perfetto_link:
        raise NotImplementedError("create_perfetto_link is jax.profiler's; the port writes "
                                  "a Chrome trace that Perfetto opens")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Named region for the profiler timeline."""
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def maybe_trace(default_logdir: Optional[str] = None):
    """Trace iff VCODER_TPU_TRACE (or default_logdir) is set."""
    logdir = os.environ.get("VCODER_TPU_TRACE", default_logdir)
    if logdir:
        with trace(logdir):
            yield logdir
    else:
        yield None


class StepTimer:
    """Accumulates named duration samples; prints percentile summaries."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.samples.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.samples.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
            }
        return out

    def format_summary(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(
                f"{name}: n={s['count']} mean={s['mean_ms']:.2f}ms"
                f" p50={s['p50_ms']:.2f}ms p90={s['p90_ms']:.2f}ms"
                f" p99={s['p99_ms']:.2f}ms"
            )
        return "\n".join(lines)
