"""flash_roofline.train (%, device trace), kernels (``ops/flash_attention.py``
-> ``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``): over the training steps of
the traced slice, the bound time of one causal forward and one backward a
layer over the valid rows (``counts.flash_fwd_call``, ``flash_bwd_call``)
over the device time of the kernels named in ``KERNELS`` (the decoder's
d128 forward -- the tower's d64 is another instantiation -- and both
backward kernels). A forward that remat runs again is device time the
bound does not count."""

from portbench import counts

KERNELS = ("flash_fwd_sm90<128>", "flash_bwd_dq", "flash_bwd_dkv")


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = run.traced
    spent = run.trace.device_time_s(KERNELS)
    if not steps or not spent:
        return None
    d = run.dims
    bound = sum(d["L"] * (counts.bound_s(*counts.flash_fwd_call(d, s.rows))
                          + counts.bound_s(*counts.flash_bwd_call(d, s.rows))) for s in steps)
    return 100.0 * bound / spent
