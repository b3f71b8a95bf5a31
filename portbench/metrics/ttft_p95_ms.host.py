"""ttft_p95_ms.host (ms, host clock), the engine as its clients see it: the
95th percentile, over every request due in the window, of the time from when
it was due to its first token (the end of the step that returned it). A
request with no first token when the window closes counts at its wait so
far (what a traced run profiles after the window is not counted). Linear
interpolation between order statistics (numpy's default)."""

import numpy as np


def read(run):
    if run.kind != "serve":
        return None
    waits = []
    for r in run.served.values():
        if not run.t0 <= r.due <= run.t0 + run.seconds:
            continue
        first = r.times[0] if r.times and r.times[0] <= run.t1 else run.t1
        waits.append(first - r.due)
    if not waits:
        return None
    return float(np.percentile(waits, 95)) * 1e3
