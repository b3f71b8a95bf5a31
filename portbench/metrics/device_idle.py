"""device_idle (%, device trace), device (H100): the share of the window in
which no operation (kernel, copy or set) ran on the device. One reader for
every cell's ``device_idle.*``.

The profiler slows the host, so the traced slice (after the window, at the
same load) runs fewer steps a second than the window did, and its own idle
share reads high. So the slice gives the device's busy time per unit of
work, and the window's work and wall give the share:
1 - (busy per unit in the slice x the window's units) / the window's wall.

* Training: a unit is one position of a batch as the feed padded it.
* Serving: the busy time inside each ``step`` span of the slice; a step that
  admits nothing gives the busy time of a decode step, and the steps that
  admit give, beyond it, the busy time per admitted prompt position. The
  window's steps and admitted positions weigh them.
"""

import statistics


def read(run):
    tr = run.trace
    if tr is None or not run.traced or not run.steps or run.window_s <= 0:
        return None
    if run.kind == "train":
        busy = tr.busy_s * sum(s.padded for s in run.steps) / sum(s.padded for s in run.traced)
        return 100.0 * (1.0 - busy / run.window_s)
    each = tr.busy_in_spans("step")
    if len(each) != len(run.traced):
        return None
    decode = [b for b, s in zip(each, run.traced) if not s.prefills]
    admit = [(b, sum(s.prefills)) for b, s in zip(each, run.traced) if s.prefills]
    admitted = sum(sum(s.prefills) for s in run.steps)
    if not decode or (admitted and not admit):
        return None
    per_step = statistics.mean(decode)
    per_position = sum(b - per_step for b, _ in admit) / sum(n for _, n in admit) if admit else 0.0
    busy = per_step * len(run.steps) + per_position * admitted
    return 100.0 * (1.0 - busy / run.window_s)
