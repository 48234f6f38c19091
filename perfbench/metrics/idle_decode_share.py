"""idle_decode_share (device): the share of the profiled slice's wall time,
in %, in which the device is idle in gaps that open while the host is
inside the program's ``decode`` or ``sample`` span."""
from perfbench import portspans


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    return s.idle_share(lambda name: name in portspans.DECODE)
