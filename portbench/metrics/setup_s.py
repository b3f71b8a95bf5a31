"""setup_s (s, host clock): from the harness's first line to the first
timed operation: imports, the weights, the engine or trainer, building or
loading the kernels, warm-up, and what the traffic needs before the window
(a filled batch, the lead-in of an open loop, the checked first steps)."""


def read(run):
    return run.notes.get("setup_s")
