"""The window's arithmetic: throughput, tails over all samples, and the
drain rule of time to first token."""
import numpy as np
import pytest

from perfbench import window
from perfbench.traffic import Request


def req(rid, due, times):
    r = Request(rid, due, np.zeros(4, np.int64), len(times))
    r.token_times = list(times)
    r.tokens = [1] * len(times)
    return r


def test_tokens_in_window():
    reqs = [req(0, 0, [0.5, 1.0, 1.5, 2.0]), req(1, 0, [1.9, 2.1])]
    # [1, 2): 1.0, 1.5 of the first, 1.9 of the second
    assert window.tokens_in(reqs, 1.0, 2.0) == 3


def test_token_gaps_are_every_gap_ending_inside():
    reqs = [req(0, 0, [0.0, 1.0, 3.0, 3.5]), req(1, 0, [2.0, 2.25])]
    assert sorted(window.token_gaps(reqs, 1.0, 3.2)) == [0.25, 1.0, 2.0]
    gaps = window.token_gaps(reqs, 0.0, 10.0)
    assert window.percentile(gaps, 50) == pytest.approx(np.median(gaps))


def test_percentile_is_over_all_samples():
    values = list(range(1, 101))
    assert window.percentile(values, 95) == pytest.approx(95.05)
    with pytest.raises(ValueError):
        window.percentile([], 95)


def test_ttft_from_due_and_drain_rule():
    origin = 100.0
    reqs = [req(0, 1.0, [102.0]), req(1, 5.0, [107.5]), req(2, 9.0, [])]
    due = window.due_in(reqs, origin, 100.5, 106.0)
    assert [r.rid for r in due] == [0, 1]
    assert window.first_token_waits(due, origin) == [1.0, 2.5]
    # a request due in the window that never got its first token is an error
    with pytest.raises(ValueError):
        window.first_token_waits(window.due_in(reqs, origin, 100.0, 110.0),
                                 origin)
