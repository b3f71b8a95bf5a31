"""paged_attn_roofline (%, device trace), kernels (``ops/paged_attention.py``
-> ``csrc/paged_attn.cu``): over the decode steps of the traced slice, the
bound time of their decode attention (each layer one call over the active
rows, ``counts.paged_decode_call`` from the harness's own lengths) over the
device time of the kernels named in ``KERNELS``. The slice follows the
window at the same load."""

from portbench import counts

KERNELS = ("paged_attn_split", "paged_attn_tile")


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    steps = [s for s in run.traced if s.contexts]
    spent = run.trace.device_time_s(KERNELS)
    if not steps or not spent:
        return None
    d = run.dims
    bound = sum(d["L"] * counts.bound_s(*counts.paged_decode_call(d, s.contexts)) for s in steps)
    return 100.0 * bound / spent
