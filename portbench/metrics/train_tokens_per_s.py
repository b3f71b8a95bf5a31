"""train_tokens_per_s (tokens/s, host clock): valid positions (text and
picture positions, padding left out) of every training step the window
finished, over the window's length."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    return sum(s.tokens for s in run.steps) / run.window_s
