"""mfu.train (%, host clock and counted FLOPs), model step (``models/vcoder.py``,
``models/llama.py``, ``train/step.py``): the model FLOPs of every training
step of the window (``counts.train_row_flops``: forward, activation
gradients, the trainable seg projector's gradients, the tower's forward;
recompute not counted) over the window times the bf16 peak."""

from portbench import counts


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    d = run.dims
    flops = sum(counts.train_row_flops(d, n, 0) for s in run.steps for n in s.rows)
    flops += 4 * d["D"] * d["V"] * sum(s.labelled for s in run.steps)  # the head, both ways
    return 100.0 * flops / (run.window_s * counts.PEAK_BF16)
