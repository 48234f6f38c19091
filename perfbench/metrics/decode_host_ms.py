"""decode_host_ms (decode step): host milliseconds of a decode step inside
the program's ``decode`` span (``models/transformer.py:decode_step``: the
embedding, every layer's launches, the head), the mean over the profiled
slice's steps.  The step is host-bound, so this is the enqueue that the
device waits on."""
import numpy as np

from perfbench import portspans


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    return float(np.mean([s.ms(i) for i in s.where("decode")]))
