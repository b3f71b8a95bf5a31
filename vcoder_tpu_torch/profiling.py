"""Host-side step timing (a copy of ``StepTimer``, ``vcoder_tpu/profiling.py:60``).

The serving engine records ``ttft``, ``decode_step``, ``admit_stage`` and
``admit_chunk`` samples; :meth:`StepTimer.summary` gives percentiles. Host
clock only: a sample ends where the caller returns, which on CUDA is after
the step's host synchronisation (the engine reads its tokens back).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np


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
