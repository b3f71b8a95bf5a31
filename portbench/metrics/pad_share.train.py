"""pad_share.train (%, program counter), training feed (``train/trainer.py::
epoch_batches`` -> ``train/collator.py``): the share of the positions of the
window's batches that are padding, as the program's feed padded them (the
length of each batch is the program's bucket of its longest row)."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return 100.0 * (1.0 - sum(s.tokens for s in run.steps) / sum(s.padded for s in run.steps))
