"""The program's own spans (``repro_torch.tracing``) on a traced slice's
clock, for the readers of the metrics that look inside the program's call.

While the profiler collects, the program records a span at each of its
layer boundaries (``decode``, ``layer``, ``attn``, ``kv.walk``,
``coherence.prologue`` ...), stamped on ``time.perf_counter_ns``, with
counts on some.  The slice's device operations and perfbench's annotations
are on the profiler's clock.  ``read(run)`` moves the slice's records onto
the profiler's clock by the median offset between perfbench's own ``walk``
and ``step`` spans (host clock) and their ``perfbench.*`` annotations: the
annotations are the slice's, in order, so they match the run of as many
consecutive records whose durations agree best.  It gives None where there
is nothing to read: no trace, a program without the module, no record in
the slice, no match, or ``decode`` spans that do not number the slice's
decode steps.
"""
from __future__ import annotations

import bisect
import dataclasses
import statistics
from typing import Callable, Dict, List, Optional, Tuple

from .tracing import PREFIX

#: perfbench's spans that align the two clocks
ALIGN = ("walk", "step")
#: the widest median gap between matched durations that still aligns (ns)
MATCH_NS = 200_000
#: a gap is labelled by the root of the spans open at its start
DECODE = ("decode", "sample")
PROTOCOL = ("kv.", "coherence.")


@dataclasses.dataclass
class PortSpans:
    """The slice's records in opening order, on the profiler's clock."""
    names: List[str]
    parents: List[int]           # index into these lists, -1 for none
    starts: List[int]
    ends: List[int]
    counts: List[Dict[str, int]]
    gaps: List[Tuple[int, int]]  # the slice's idle device intervals
    window_ns: int

    def where(self, name: str) -> List[int]:
        return [i for i, n in enumerate(self.names) if n == name]

    def ms(self, i: int) -> float:
        return (self.ends[i] - self.starts[i]) * 1e-6

    def innermost(self, t: int) -> Optional[int]:
        """The innermost record open at ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] <= t:
            i = self.parents[i]
        return i if i >= 0 else None

    def root(self, i: int) -> int:
        while self.parents[i] >= 0:
            i = self.parents[i]
        return i

    def idle_share(self, label: Callable[[str], bool]) -> float:
        """% of the slice's wall time idle in gaps that open inside a span
        whose root's name ``label`` accepts."""
        idle = 0
        for g0, g1 in self.gaps:
            i = self.innermost(g0)
            if i is not None and label(self.names[self.root(i)]):
                idle += g1 - g0
        return 100.0 * idle / self.window_ns

    def idle_by_span(self) -> Dict[str, List[float]]:
        """Idle seconds and gaps of the slice by the innermost span open at
        each gap's start ("outside" where none is)."""
        out: Dict[str, List[float]] = {}
        for g0, g1 in self.gaps:
            i = self.innermost(g0)
            entry = out.setdefault("outside" if i is None else self.names[i],
                                   [0.0, 0])
            entry[0] += (g1 - g0) * 1e-9
            entry[1] += 1
        return out

    def decode_walks(self, name: str) -> List[int]:
        """The records called ``name`` that belong to a decode step's walk:
        the next ``decode`` or ``prefill`` at the top after them is a
        ``decode``."""
        tops = [i for i, n in enumerate(self.names)
                if n in ("decode", "prefill") and self.parents[i] < 0]
        starts = [self.starts[i] for i in tops]
        out = []
        for i in self.where(name):
            k = bisect.bisect_right(starts, self.starts[i])
            if k < len(tops) and self.names[tops[k]] == "decode":
                out.append(i)
        return out


def _offset(host: List[Tuple[str, float, float]],
            notes: List[Tuple[str, int, int]]) -> Optional[float]:
    """Profiler clock minus host clock (ns): the median over perfbench's
    ``ALIGN`` spans and their annotations, matched as the run of
    consecutive records whose durations agree best."""
    recs = [(n, s * 1e9, e * 1e9) for n, s, e in host if n in ALIGN]
    marks = sorted((a for a in notes if a[0][len(PREFIX):] in ALIGN
                    and a[0].startswith(PREFIX)), key=lambda a: a[1])
    k = len(marks)
    if not k or len(recs) < k:
        return None
    names = [a[0][len(PREFIX):] for a in marks]
    best = None
    for j in range(len(recs) - k + 1):
        run = recs[j:j + k]
        if [r[0] for r in run] != names:
            continue
        miss = statistics.median(abs((e - s) - (r[2] - r[1]))
                                 for r, (_, s, e) in zip(run, marks))
        if best is None or miss < best[0]:
            best = (miss, j)
    if best is None or best[0] > MATCH_NS:
        return None
    run = recs[best[1]:best[1] + k]
    return statistics.median(s - r[1] for r, (_, s, _) in zip(run, marks))


def read(run) -> Optional[PortSpans]:
    """The slice's records (module doc), kept on ``run`` once read."""
    if not hasattr(run, "_port_spans"):
        run._port_spans = _read(run)
    return run._port_spans


def _read(run) -> Optional[PortSpans]:
    t = run.trace
    if t is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:          # a program that records no spans
        return None
    recs = tracing.records()
    offset = _offset(run.spans.records, t.annotations) if recs else None
    if offset is None:
        return None
    index: Dict[int, int] = {}
    spans = PortSpans([], [], [], [], [], [], t.end_ns - t.start_ns)
    for k, r in enumerate(recs):
        s, e = r.start_ns + offset, r.end_ns + offset
        if not r.end_ns or s < t.start_ns or e > t.end_ns:
            continue
        index[k] = len(spans.names)
        spans.names.append(r.name)
        spans.parents.append(index.get(r.parent, -1))
        spans.starts.append(int(s))
        spans.ends.append(int(e))
        spans.counts.append(dict(r.counts))
    if len(spans.where("decode")) != len(t.step_lens) or not t.step_lens:
        return None
    spans.gaps = tracing.gaps(t.busy_intervals(), t.start_ns, t.end_ns)
    return spans
