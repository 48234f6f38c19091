"""walk_record_ms (host protocol + page walk): host milliseconds of the
program's ``kv.record`` span (``physical_tables``' loop over every block of
every row through ``record_access``), the mean over the profiled slice's
decode steps that record (every 4th; the prefill's walk left out)."""
import numpy as np

from perfbench import portspans


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    steps = s.decode_walks("kv.record")
    return float(np.mean([s.ms(i) for i in steps])) if steps else None
