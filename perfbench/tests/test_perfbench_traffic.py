"""The seeded arrival schedule and prompts."""
import numpy as np
import pytest

from perfbench import traffic

MIX = {"arrivals": "poisson", "rate_per_s": 4.0, "lead_in_s": 10,
       "batch": 32, "prompt_len": 64, "gen_len": 8, "kv_frames": 1,
       "check_requests": 1, "trace_decode_steps": 1}
BIG = 2 ** 31 + 12345


def test_same_seed_same_schedule():
    a = traffic.arrival_times(MIX, BIG, 45)
    b = traffic.arrival_times(MIX, BIG, 45)
    assert np.array_equal(a, b)
    pa = traffic.prompt(MIX, 64000, BIG, 7)
    assert np.array_equal(pa, traffic.prompt(MIX, 64000, BIG, 7))


def test_other_seed_other_order_same_work():
    a = traffic.arrival_times(MIX, BIG, 45)
    b = traffic.arrival_times(MIX, BIG + 1, 45)
    assert not np.array_equal(a, b)
    # the same counts in the lead-in and in the window, and one set of gaps
    for t in (a, b):
        assert (t < 10).sum() == 40 and ((t >= 10) & (t < 55)).sum() == 180
    gaps = lambda t, lo, hi: np.sort(np.diff(np.append(t[(t >= lo) & (t < hi)], hi)))
    assert np.allclose(gaps(a, 10, 55), gaps(b, 10, 55))
    assert not np.array_equal(traffic.prompt(MIX, 64000, BIG, 0),
                              traffic.prompt(MIX, 64000, BIG + 1, 0))


def test_gaps_are_exponential_quantiles():
    g = traffic.quantile_gaps(1000, 250.0)
    assert g.sum() == pytest.approx(250.0)
    assert np.median(g) == pytest.approx(0.25 * np.log(2), rel=0.02)


def test_backlog_is_endless_and_due_at_origin():
    mix = dict(MIX, arrivals="backlog")
    it = traffic.requests(mix, 100, BIG, 45)
    reqs = [next(it) for _ in range(100)]
    assert [r.rid for r in reqs] == list(range(100))
    assert all(r.due == 0.0 and r.prompt.shape == (64,) for r in reqs)
    assert traffic.lead_in(mix) == 0.0


def test_mix_files_load():
    for name in ("decode_backlog", "rag_poisson"):
        mix = traffic.load(name)
        bt = 16
        blocks = -(-(mix["prompt_len"] + mix["gen_len"]) // bt) + 1
        assert mix["kv_frames"] == mix["batch"] * blocks


def test_bad_mix_is_refused(tmp_path):
    (tmp_path / "x.json").write_text('{"arrivals": "poisson"}')
    with pytest.raises(ValueError):
        traffic.load("x", tmp_path)
