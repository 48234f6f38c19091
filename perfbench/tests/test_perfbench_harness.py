"""A traced run's result, and what the window's records give the readers."""
import pytest

from perfbench.driver import Prefill, Step
from perfbench.harness import Run
from perfbench.tests import smoke
from perfbench.tracing import Spans


def test_traced_run_reports_its_layers():
    r = smoke.run("silu.poisson", trace=True)
    assert r["correct"], r["checks"]
    # the CPU has no device operations: the kernels' rooflines read nothing;
    # the metrics that list their cells leave this one out
    assert {"walk_host_ms", "prologue_ms", "decode_step_ms", "mfu",
            "idle_share"} == set(r["metrics"])
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"


def test_records_counted_by_their_share_in_window():
    run = Run({}, {}, 10.0, 0.0, 1.0, 11.0, 1.0, [], [], [], Spans(), 1)
    assert run.share_in_window(Prefill(0.0, 2.0, 4, 4, 8)) == pytest.approx(0.5)
    assert run.share_in_window(Step(10.5, 11.5, (9,), (0, 0))) == pytest.approx(0.5)
    assert run.share_in_window(Step(11.0, 12.0, (9,), (0, 0))) == 0.0
    assert run.in_window([Step(10.5, 10.9, (9,), (0, 0)),
                          Step(10.9, 11.1, (9,), (0, 0))])[0].t1 == 10.9
