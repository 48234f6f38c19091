"""Spans around the driver's calls into each layer of the program, and the
profiler over a bounded slice of a traced run's window.

Spans are kept in memory as (name, start, end) on the host clock.  In a
traced run each span is also a ``torch.profiler.record_function``
annotation, so the slice's trace can say what the host was doing during
each gap in which the device ran nothing.  The slice is read from the
profiler's raw events (``kineto_results.events()``), not through
``key_averages``: the device's operations (kernels, copies, sets) with
their start and duration, and the annotations.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "perfbench."
SLICE = PREFIX + "slice"
TOP = 10


class Spans:
    """(name, start, end) host-clock spans; ``annotate`` also marks each in
    the profiler's trace."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        if self.annotate:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.records.append((name, start, time.perf_counter()))

    def of(self, name: str, w0: float, w1: float) -> List[float]:
        """Durations (s) of the spans called ``name`` that end in [w0, w1)."""
        return [e - s for n, s, e in self.records if n == name and w0 <= e < w1]


@dataclasses.dataclass
class TraceSlice:
    """The device's operations and the host's annotations in the profiled
    slice, nanoseconds on the profiler's clock."""
    start_ns: int
    end_ns: int
    ops: List[Tuple[str, int, int]]            # (name, start, duration)
    annotations: List[Tuple[str, int, int]]    # (name, start, end)
    prefill: Optional[Tuple[int, int]] = None  # (rows, prompt length)
    #: the live rows' lengths of each decode step in the slice
    step_lens: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        slice."""
        spans = sorted((max(s, self.start_ns), min(s + d, self.end_ns))
                       for _, s, d in self.ops)
        merged: List[List[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, part: str, exclude: str = "") -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        ``part`` (and not ``exclude``)."""
        hits = [d for n, _, d in self.ops
                if part in n and not (exclude and exclude in n)]
        return len(hits), sum(hits) * 1e-9

    def top_ops(self) -> List[List]:
        total: Dict[str, int] = {}
        for n, _, d in self.ops:
            total[n] = total.get(n, 0) + d
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], d * 1e-9] for n, d in top]

    def idle_by_host(self) -> List[List]:
        """Idle device time in the slice, summed by the innermost host
        annotation open at each gap's start ("other" outside any)."""
        busy = self.busy_intervals()
        gaps, cursor = [], self.start_ns
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.end_ns:
            gaps.append((cursor, self.end_ns))
        # the driver's spans do not nest: the last one to open before a
        # gap's start is the only one that can hold it
        notes = sorted(a for a in self.annotations if a[0] != SLICE)
        notes.sort(key=lambda a: a[1])
        starts = [a[1] for a in notes]
        total: Dict[str, List] = {}
        for g0, g1 in gaps:
            i = bisect.bisect_right(starts, g0) - 1
            label = (notes[i][0][len(PREFIX):] if i >= 0 and g0 < notes[i][2]
                     else "other")
            entry = total.setdefault(label, [0, 0])
            entry[0] += g1 - g0
            entry[1] += 1
        top = sorted(total.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[f"{label} ({n} gaps)", ns * 1e-9] for label, (ns, n) in top]


class Profiler:
    """``torch.profiler`` over one slice of the window."""

    def __init__(self, spans: Spans) -> None:
        self.spans = spans
        self._prof = None
        self._mark = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._mark = torch.profiler.record_function(SLICE)
        self._mark.__enter__()
        self.spans.annotate = True

    def start_stop(self) -> None:
        """Start and stop once, tracing nothing: the first start
        initialises the device's tracing, which a run does in set-up."""
        self.start()
        self.stop()

    def stop(self) -> TraceSlice:
        self.spans.annotate = False
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        ops, notes = [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            if name.startswith(PREFIX):
                if e.device_type() == torch.autograd.DeviceType.CPU:
                    notes.append((name, e.start_ns(), e.end_ns()))
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA \
                    and not e.is_user_annotation():
                ops.append((name, e.start_ns(), e.duration_ns()))
        (_, s0, s1), = [a for a in notes if a[0] == SLICE]
        self._prof = None
        return TraceSlice(s0, s1, ops, notes)
