"""decode_graph_share (decode step): the share, in %, of the profiled
slice's ``decode`` spans that replay the step's CUDA graph (the program's
count ``graph`` = 1, ``launch/step_graph.py``); an eager step counts 0.
None where the program's ``decode`` spans carry no such count."""
from perfbench import portspans


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    counts = [s.counts[i].get("graph") for i in s.where("decode")]
    if not counts or None in counts:
        return None
    return 100.0 * sum(counts) / len(counts)
