"""coherence_fill_share (coherence): the share, in %, of the prologue's
all-gathered slots that carry an entry: the mutations and misses the
program's ``coherence.inputs`` spans counted, over their mutation and miss
slots (the budgets times the pods), summed over the profiled slice's
prologue rounds."""
from perfbench import portspans


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    counts = [s.counts[i] for i in s.where("coherence.inputs")]
    slots = sum(c["mutation_slots"] + c["miss_slots"] for c in counts)
    if not slots:
        return None
    return 100.0 * sum(c["mutations"] + c["misses"] for c in counts) / slots
