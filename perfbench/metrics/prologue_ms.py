"""prologue_ms (coherence): milliseconds a decode step between the CUDA
events ``build_serve_step``'s ``prologue_timer`` records around each
coherence prologue, extra rounds included, the mean over the window's
steps.  The step is host-bound, so the events span enqueue time as well as
device time."""
import numpy as np


def read(run):
    steps = run.in_window(run.steps)
    return float(np.mean([s.prologue_ms for s in steps])) if steps else None
