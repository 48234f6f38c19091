"""ttft_p90_ms: the 90th percentile of time to first token over every
request due inside the window, each timed from when it was due (the run
serves on after the window until each has its first token)."""
from perfbench.window import due_in, first_token_waits, percentile


def read(run):
    due = due_in(run.requests, run.origin, run.w0, run.w1)
    return 1e3 * percentile(first_token_waits(due, run.origin), 90) if due else None
