"""decode_step_ms (ms, host clock), engine layer (``serve/paged_engine.py``):
the mean of the engine's own ``StepTimer`` samples named ``decode_step``
over the window: one batched decode step each, ending after the host reads
the step's tokens back. One reader for every cell's ``decode_step_ms.*``."""


def read(run):
    s = run.timer.get("decode_step")
    return 1e3 * sum(s) / len(s) if run.kind == "serve" and s else None
