"""The traced slice's arithmetic: busy union, idle share by host span."""
import pytest

from perfbench.tracing import SLICE, Spans, TraceSlice


def slice_():
    ops = [("k1", 100, 50), ("k2", 120, 60), ("k3", 300, 100), ("k1", 950, 100)]
    notes = [(SLICE, 0, 1000), ("perfbench.walk", 180, 260),
             ("perfbench.step", 260, 300), ("perfbench.deliver", 400, 900)]
    return TraceSlice(0, 1000, ops, notes)


def test_busy_union_clipped_to_slice():
    t = slice_()
    assert t.busy_intervals() == [(100, 180), (300, 400), (950, 1000)]
    assert t.busy_s() == pytest.approx(230e-9)
    assert t.window_s == pytest.approx(1e-6)


def test_kernel_seconds_and_top():
    t = slice_()
    assert t.kernel_seconds("k1") == (2, pytest.approx(150e-9))
    assert t.top_ops()[0] == ["k1", pytest.approx(150e-9)]


def test_idle_labelled_by_host_span():
    got = dict(slice_().idle_by_host())
    # [0,100) before any span, [180,300) from inside the walk, [400,950)
    # inside deliver
    assert got["other (1 gaps)"] == pytest.approx(100e-9)
    assert got["walk (1 gaps)"] == pytest.approx(120e-9)
    assert got["deliver (1 gaps)"] == pytest.approx(550e-9)


def test_spans_in_window():
    s = Spans()
    s.records = [("walk", 0.0, 1.0), ("walk", 1.0, 2.5), ("step", 0, 2)]
    assert s.of("walk", 1.5, 3.0) == [1.5]
