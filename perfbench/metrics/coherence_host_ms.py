"""coherence_host_ms (coherence): host milliseconds a decode step spends in
the program's ``coherence.inputs`` (packing the step's buffers and their
copies to the device) and ``coherence.prologue`` spans (K3 and the pod
collectives, extra rounds included), over the profiled slice's decode
steps."""
from perfbench import portspans


def read(run):
    s = portspans.read(run)
    if s is None:
        return None
    ms = sum(s.ms(i) for name in ("coherence.inputs", "coherence.prologue")
             for i in s.where(name))
    return ms / len(s.where("decode"))
