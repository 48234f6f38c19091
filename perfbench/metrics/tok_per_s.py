"""tok_per_s: output tokens delivered to the host inside the window, over
the window's seconds (padding rows deliver nothing)."""
from perfbench.window import tokens_in


def read(run):
    return tokens_in(run.requests, run.w0, run.w1) / run.seconds
