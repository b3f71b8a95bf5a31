"""itl_p95_ms.host (ms, host clock), the engine as its clients see it: the
95th percentile of every gap between two consecutive output tokens of one
request, both returned in the window. Linear interpolation between order
statistics (numpy's default)."""

import numpy as np


def read(run):
    if run.kind != "serve":
        return None
    gaps = []
    for r in run.served.values():
        t = [x for x in r.times if run.t0 <= x <= run.t1]
        gaps += [b - a for a, b in zip(t, t[1:])]
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
