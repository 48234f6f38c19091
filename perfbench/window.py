"""The measured window's arithmetic: what the end-to-end metrics take from
the requests' delivery times.  Every figure is over all the work and all
the time of the window, or the tail of all its samples; times are seconds
of one host clock (``time.perf_counter``).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from .traffic import Request


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default); raises on no samples."""
    if len(values) == 0:
        raise ValueError("a percentile of no samples")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def tokens_in(reqs: Iterable[Request], w0: float, w1: float) -> int:
    """Output tokens delivered to the host inside [w0, w1)."""
    return sum(int(((t >= w0) & (t < w1)).sum())
               for t in (np.asarray(r.token_times) for r in reqs))


def token_gaps(reqs: Iterable[Request], w0: float, w1: float) -> List[float]:
    """Gaps between consecutive delivered tokens of each request, for every
    gap whose later token was delivered inside [w0, w1)."""
    out: List[float] = []
    for r in reqs:
        t = np.asarray(r.token_times)
        if t.size < 2:
            continue
        later = t[1:]
        keep = (later >= w0) & (later < w1)
        out.extend((later - t[:-1])[keep].tolist())
    return out


def due_in(reqs: Iterable[Request], origin: float, w0: float, w1: float
           ) -> List[Request]:
    """Requests due inside [w0, w1) (``due`` counts from ``origin``)."""
    return [r for r in reqs if w0 <= origin + r.due < w1]


def first_token_waits(reqs: Iterable[Request], origin: float) -> List[float]:
    """Time to first token of each request, from when it was due: a stall
    counts against every request behind it.  A request without a first
    token raises: the drain rule serves every request due in the window."""
    out = []
    for r in reqs:
        if not r.token_times:
            raise ValueError(f"request {r.rid} never got its first token")
        out.append(r.token_times[0] - (origin + r.due))
    return out
