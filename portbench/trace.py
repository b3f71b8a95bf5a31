"""The device trace of a traced run: ``torch.profiler`` over a slice of the
window, reduced to kernel intervals once the window has closed.

* busy: the union of the intervals in which an operation (kernel, copy or
  set) ran on the device, in all and inside each of the harness's spans.
* a kernel set's device time: the summed durations of the kernels whose
  names hold one of the set's names.
* idle gaps: the holes in that union, each labelled by the innermost host
  span of the harness (``bench.*``, ``record_function``) open at its start.
"""

from __future__ import annotations

import bisect
import time
from typing import List, Optional, Tuple

SPAN_PREFIX = "bench."


def span(name: str):
    """A harness span in the trace (a no-op cost when nothing profiles)."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


def _sync() -> bool:
    """Wait for the card, if there is one (a CPU test traces host spans only)."""
    import torch

    if not torch.cuda.is_available():
        return False
    torch.cuda.synchronize()
    return True


class Slice:
    """Starts the profiler on ``begin`` and stops it on ``end``; the caller
    places both between steps."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if _sync():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t0 = time.perf_counter()

    def end(self) -> None:
        _sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None


def _ns(ev, what: str) -> Optional[int]:
    for attr, mul in ((f"{what}_ns", 1), (f"{what}_us", 1000)):
        f = getattr(ev, attr, None)
        if f is not None:
            return int(f() * mul)
    return None


def _events(prof):
    """(name, on the device, start ns, duration ns) of every event: from
    kineto's raw results, else from the profiler's function events."""
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for ev in results.events():
            start, dur = _ns(ev, "start"), _ns(ev, "duration")
            if start is not None and dur is not None:
                yield ev.name(), "cuda" in str(ev.device_type()).lower(), start, dur
        return
    for ev in prof.events():
        on_device = "cuda" in str(ev.device_type).lower()
        a, b = ev.time_range.start, ev.time_range.end
        yield ev.name, on_device, int(a * 1000), int((b - a) * 1000)


class Trace:
    """Device intervals and host spans of a finished slice."""

    def __init__(self, sl: Slice):
        self.window_s = sl.t1 - sl.t0
        self.kernels: List[Tuple[str, int, int]] = []  # name, start ns, end ns
        self.spans: List[Tuple[str, int, int]] = []
        for name, on_device, start, dur in _events(sl.prof):
            if name.startswith(SPAN_PREFIX):
                if not on_device:
                    self.spans.append((name[len(SPAN_PREFIX):], start, start + dur))
                continue
            if on_device and dur > 0 and not name.startswith("ProfilerStep"):
                self.kernels.append((name, start, start + dur))
        self.kernels.sort(key=lambda k: k[1])
        self._union = self._merge()

    def _merge(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, a, b in self.kernels:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union) * 1e-9

    def busy_in_spans(self, name: str) -> List[float]:
        """The device's busy seconds inside each host span ``name`` of the
        harness, in the order the spans began."""
        starts = [a for a, _ in self._union]
        out = []
        for _, a, b in sorted((s for s in self.spans if s[0] == name), key=lambda s: s[1]):
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            ns = 0
            for x, y in self._union[i:]:
                if x >= b:
                    break
                ns += max(0, min(b, y) - max(a, x))
            out.append(ns * 1e-9)
        return out

    def device_time_s(self, names) -> Optional[float]:
        """Summed durations of the kernels named by any of ``names``; None
        when none ran."""
        hits = [b - a for n, a, b in self.kernels if any(x in n for x in names)]
        return sum(hits) * 1e-9 if hits else None

    def top_ops(self, k: int = 10) -> List[list]:
        tot: dict = {}
        for n, a, b in self.kernels:
            tot[n] = tot.get(n, 0) + (b - a)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v * 1e-9] for n, v in best]

    def idle_gaps(self, k: int = 10) -> List[list]:
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(self._union, self._union[1:])]
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:k]:
            inside = [s for s in self.spans if s[1] <= a < s[2]]
            label = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "outside spans"
            out.append([label, (b - a) * 1e-9])
        return out
