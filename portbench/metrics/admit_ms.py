"""admit_ms (ms, host clock), engine admission (``serve/engine.py::_admit``
and the paged engine's ``_prefill``: planning, the tower, the projectors,
the splice, the dense prefill and its scatter into pages, the first
token): the mean of the engine's ``StepTimer`` samples named ``ttft``, one
around each admission of the window (the engine's name for its B=1
admission; the chunked path's ``admit_stage`` is not taken)."""


def read(run):
    s = run.timer.get("ttft")
    return 1e3 * sum(s) / len(s) if run.kind == "serve" and s else None
