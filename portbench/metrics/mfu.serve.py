"""mfu.serve (%, host clock and counted FLOPs), model step: the FLOPs of every
admission (``counts.prefill_flops``: the tower, the projectors, the decoder
over the prompt, the head at its last position) and every decoded token
(``counts.decode_flops``, attention over its live context) of the window,
over the window times the bf16 peak."""

from portbench import counts


def read(run):
    if run.kind != "serve" or not run.steps:
        return None
    d = run.dims
    flops = sum(counts.prefill_flops(d, n) for s in run.steps for n in s.prefills)
    flops += sum(counts.decode_flops(d, c) for s in run.steps for c in s.contexts)
    return 100.0 * flops / (run.window_s * counts.PEAK_BF16)
