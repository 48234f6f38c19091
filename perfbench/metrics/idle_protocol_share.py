"""idle_protocol_share (host protocol + page walk): the share of the
profiled slice's wall time, in %, in which the device is idle in gaps that
open while the host is inside one of the program's ``kv.*`` or
``coherence.*`` spans (admission, extension, the walk, the coherence
buffers and prologue)."""
from perfbench import portspans


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    return s.idle_share(lambda name: name.startswith(portspans.PROTOCOL))
