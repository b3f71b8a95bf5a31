"""rows_per_step (rows, program counter), engine layer: the output tokens
the window's ``step()`` calls returned, over the calls that returned any --
the batch's occupancy, counted from ``step()``'s return."""


def read(run):
    if run.kind != "serve":
        return None
    emitting = [s.tokens for s in run.steps if s.tokens]
    return sum(emitting) / len(emitting) if emitting else None
