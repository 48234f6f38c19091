"""The port's closed serving loop against the reference's: Poisson arrivals
driving KV-block churn through the simulator's mm engine, one row of
latency and counters per serving policy."""
from __future__ import annotations

import dataclasses

import pytest

from repro import serving as R
from repro_torch import serving as P

N_REQUESTS = 24


def test_torch_serving_poisson_trace_equals_reference():
    for rate, seed in ((2e6, 0), (5e5, 3)):
        want = [dataclasses.asdict(r) for r in R.poisson_trace(40, rate, seed=seed)]
        got = [dataclasses.asdict(r) for r in P.poisson_trace(40, rate, seed=seed)]
        assert got == want
    assert [r.total_blocks for r in P.poisson_trace(40, 1e6)] == \
        [r.total_blocks for r in R.poisson_trace(40, 1e6)]
    with pytest.raises(ValueError):
        P.poisson_trace(4, 0.0)


def test_torch_serving_nominal_capacity_equals_reference():
    assert P.nominal_capacity_rps() == R.nominal_capacity_rps()
    kw = dict(n_workers=4, slots_per_worker=2, step_ns=25_000.0,
              mean_decode_steps=12.0)
    assert P.nominal_capacity_rps(**kw) == R.nominal_capacity_rps(**kw)
    assert P.SERVING_POLICIES == R.SERVING_POLICIES
    assert P.__all__ == R.__all__


@pytest.mark.parametrize("engine", ["trace", "batch"])
@pytest.mark.parametrize("policy", sorted(R.SERVING_POLICIES))
def test_torch_serving_closed_loop_rows_equal_reference(policy, engine):
    rate = 0.9 * R.nominal_capacity_rps()
    want = R.run_closed_loop(policy, arrival_rate_rps=rate,
                             n_requests=N_REQUESTS, seed=5, engine=engine)
    got = P.run_closed_loop(policy, arrival_rate_rps=rate,
                            n_requests=N_REQUESTS, seed=5, engine=engine)
    assert got == want
    assert got["policy"] == policy


def test_torch_serving_closed_loop_refuses_unknown_policy():
    with pytest.raises(ValueError, match="unknown serving policy"):
        P.run_closed_loop("eager", arrival_rate_rps=1e6, n_requests=2)
