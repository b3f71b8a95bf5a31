"""serve_tokens_per_s (tokens/s, host clock): every output token the engine
emitted in the window (first tokens included), over the window's length."""


def read(run):
    if run.kind != "serve" or not run.steps:
        return None
    return sum(s.tokens for s in run.steps) / run.window_s
