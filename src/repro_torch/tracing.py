"""Named host spans at the layer boundaries of the served path, and the
interval arithmetic that reads a profiled trace.

``span(name, **counts)`` marks a block: the page walk, the coherence
prologue, a decode step and its layers.  It records only while a
``torch.profiler`` collects (``torch.autograd.profiler._is_profiler_enabled``)
or inside ``recording()``, and never inside ``paused()`` (a CUDA graph's
capture).  Off, it is two flag reads and a shared no-op context: it makes no
tensor, calls nothing on the device and never synchronises.  On, it appends a ``Record`` (name, the index of the enclosing
span, start and end on ``time.perf_counter_ns``, counts) to a list in memory
and opens ``torch.profiler.record_function("repro_torch." + name)``, so that
an exported trace shows the range; the record's stamps are taken inside the
range, so that it lies within the range's event.  The ``with`` gives the record (None when
off): a caller that counts what the block did adds to ``record.counts`` only
when it is there, so nothing is counted when nothing records.

``records()`` reads the list and ``take()`` reads and clears it.  The spans
of one process nest (the served path runs on one thread), so the list is in
the order the spans opened and a parent comes before its children.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterable, Iterator, List, Tuple

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."

Interval = Tuple[int, int]


@dataclasses.dataclass
class Record:
    name: str
    parent: int                  # index of the enclosing span, -1 for none
    start_ns: int
    end_ns: int                  # 0 while the span is open
    counts: Dict[str, int]


_records: List[Record] = []
_open: List[int] = []
_forced = 0
_paused = 0
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("record", "_range")

    def __init__(self, name: str, counts: Dict[str, int]) -> None:
        self.record = Record(name, -1, 0, 0, counts)

    def __enter__(self) -> Record:
        self._range = torch.profiler.record_function(PREFIX + self.record.name)
        self._range.__enter__()
        self.record.parent = _open[-1] if _open else -1
        _open.append(len(_records))
        _records.append(self.record)
        self.record.start_ns = time.perf_counter_ns()
        return self.record

    def __exit__(self, *exc) -> bool:
        self.record.end_ns = time.perf_counter_ns()
        _open.pop()
        self._range.__exit__(*exc)
        return False


def on() -> bool:
    """Whether a ``span`` opened here would record (module doc)."""
    return not _paused and bool(_forced or _profiler._is_profiler_enabled)


def span(name: str, **counts: int):
    """A context over the block named ``name`` (module doc)."""
    if _paused or not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, counts)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block whether or not a profiler runs."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Record nothing inside the block, even under a profiler or inside
    ``recording()``: a CUDA graph's capture runs the step's code and
    launches nothing."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def records() -> List[Record]:
    return list(_records)


def take() -> List[Record]:
    """The records, and an empty list from now (call it with no span
    open)."""
    out = list(_records)
    _records.clear()
    return out


# ------------------------------------------------------------ intervals
def union(intervals: Iterable[Interval], start: int, end: int
          ) -> List[Interval]:
    """The union of ``intervals`` (start, end) clipped to [start, end), as
    sorted disjoint intervals: the device's busy time from its operations,
    which may overlap on different streams."""
    out: List[List[int]] = []
    for s, e in sorted((max(s, start), min(e, end)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: List[Interval], start: int, end: int) -> List[Interval]:
    """The intervals of [start, end) outside ``busy`` (``union``'s output)."""
    out, cursor = [], start
    for s, e in busy:
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < end:
        out.append((cursor, end))
    return out


def profiled(prof) -> Tuple[List[Interval], List[Tuple[str, int, int]]]:
    """A finished ``torch.profiler.profile``'s device operations (kernels,
    copies, sets) as (start, end) and its host ranges named with
    ``PREFIX`` as (name, start, end), nanoseconds on the profiler's clock."""
    ops, ranges = [], []
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.name().startswith(PREFIX):
            ranges.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.device_type() == cuda and not e.is_user_annotation():
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return ops, ranges

