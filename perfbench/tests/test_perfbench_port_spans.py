"""The readers of the program's own spans (``portspans.py`` and its six
metrics) on a planted slice with planted program records of known shares
and means, and on traced smoke runs."""
import sys
import time

import pytest
import torch

from perfbench import portspans
from perfbench.harness import HERE, Run, load_module, run_cell
from perfbench.tests import smoke
from perfbench.tracing import SLICE, Spans, TraceSlice
import repro_torch
from repro_torch import tracing
from repro_torch.tracing import Record

METRICS = ("decode_host_ms", "coherence_host_ms", "walk_record_ms",
           "idle_decode_share", "idle_protocol_share", "coherence_fill_share")
#: the host clock's reading at the slice clock's 0 (ns)
BASE = 10 ** 12
K = 1_000


def _port_records():
    """A prefill and two decode steps, on the slice's clock (ns); the first
    step's walk records, the second's does not."""
    recs = []

    def add(name, s, e, parent=-1, **counts):
        recs.append(Record(name, parent, BASE + s, BASE + e, counts))
        return len(recs) - 1

    walk = add("kv.walk", 10 * K, 20 * K)
    add("kv.record", 11 * K, 15 * K, walk, accesses=8, misses=1, fetches=1)
    add("prefill", 20 * K, 100 * K)
    walk = add("kv.walk", 110 * K, 130 * K)
    add("kv.record", 112 * K, 120 * K, walk, accesses=8, misses=0, fetches=0)
    add("coherence.inputs", 130 * K, 134 * K, mutations=2, misses=1,
        mutation_slots=4096, miss_slots=1024)
    add("coherence.prologue", 134 * K, 140 * K, wire_bytes=96, k3=2)
    dec = add("decode", 140 * K, 300 * K)
    layer = add("layer", 150 * K, 290 * K, dec, index=0)
    attn = add("attn", 150 * K, 200 * K, layer)
    add("attn.kernel", 180 * K, 190 * K, attn)
    add("ffn", 200 * K, 290 * K, layer)
    add("sample", 300 * K, 310 * K)
    add("kv.walk", 400 * K, 410 * K)
    add("coherence.inputs", 410 * K, 412 * K, mutations=0, misses=0,
        mutation_slots=4096, miss_slots=1024)
    add("coherence.prologue", 412 * K, 420 * K, wire_bytes=0, k3=2)
    add("decode", 420 * K, 600 * K)
    add("sample", 600 * K, 610 * K)
    return recs


#: idle gaps (slice clock): in attn, attn.kernel, sample (running past its
#: end), kv.record, coherence.prologue, and two outside every span
GAPS = [(0, 5 * K), (115 * K, 117 * K), (136 * K, 138 * K),
        (160 * K, 170 * K), (185 * K, 195 * K), (305 * K, 330 * K),
        (700 * K, 1000 * K)]
#: the device's operations, two of them overlapping, between the gaps
OPS = [("a", 5 * K, 55 * K), ("b", 50 * K, 65 * K), ("c", 65 * K, 50 * K),
       ("d", 117 * K, 19 * K), ("e", 138 * K, 22 * K), ("f", 170 * K, 15 * K),
       ("g", 195 * K, 110 * K), ("h", 330 * K, 370 * K)]


def _planted_run(step_lens=((9,), (10,))):
    # perfbench's spans on the host clock (s), one earlier step outside the
    # slice; their annotations on the slice's clock, one of them 3 us late
    # (the median offset is 0)
    host = [(8 * K, 129 * K, "walk", 3 * K), (129 * K, 312 * K, "step", 0),
            (398 * K, 409 * K, "walk", 0), (409 * K, 612 * K, "step", 0)]
    spans = Spans()
    spans.records = [("walk", (BASE - 900 * K) * 1e-9, (BASE - 850 * K) * 1e-9),
                     ("step", (BASE - 850 * K) * 1e-9, (BASE - 700 * K) * 1e-9)]
    spans.records += [(n, (BASE + s) * 1e-9, (BASE + e) * 1e-9)
                      for s, e, n, _ in host]
    notes = [(SLICE, 0, 1000 * K)] + [("perfbench." + n, s + late, e)
                                      for s, e, n, late in host]
    trace = TraceSlice(0, 1000 * K, list(OPS), notes,
                       step_lens=list(step_lens))
    return Run({}, {}, 1.0, 0.0, 0.0, 1.0, 0.0, [], [], [], spans, 1, trace)


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(tracing, "records", _port_records)


def _read(name, run):
    return load_module(HERE / "metrics", name).read(run)


def test_planted_slice_gaps(planted):
    s = portspans.read(_planted_run())
    assert s.gaps == GAPS
    assert s.names[0] == "kv.walk" and s.starts[0] == 10 * K
    idle = {k: (pytest.approx(v[0]), v[1]) for k, v in s.idle_by_span().items()}
    assert idle == {"outside": (pytest.approx(305e-6), 2),
                    "kv.record": (pytest.approx(2e-6), 1),
                    "coherence.prologue": (pytest.approx(2e-6), 1),
                    "attn": (pytest.approx(10e-6), 1),
                    "attn.kernel": (pytest.approx(10e-6), 1),
                    "sample": (pytest.approx(25e-6), 1)}


@pytest.mark.parametrize("metric,want", [
    ("decode_host_ms", 0.170),                  # 160 and 180 us
    ("coherence_host_ms", 0.010),               # 20 us over 2 steps
    ("walk_record_ms", 0.008),                  # the prefill's left out
    ("idle_decode_share", 4.5),                 # 10 + 10 + 25 of 1 000 us
    ("idle_protocol_share", 0.4),               # 2 + 2
    ("coherence_fill_share", 100 * 3 / 10240),
])
def test_planted_slice_readings(planted, metric, want):
    assert _read(metric, _planted_run()) == pytest.approx(want)


def test_nothing_to_read(monkeypatch, planted):
    # decode spans that do not number the slice's steps
    for name in METRICS:
        assert _read(name, _planted_run(step_lens=((9,),))) is None
    run = _planted_run()
    run.trace = None
    assert all(_read(name, run) is None for name in METRICS)
    # no record; no such module (the program before it recorded spans)
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert all(_read(name, _planted_run()) is None for name in METRICS)
    monkeypatch.setattr(tracing, "records", _port_records)
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert all(_read(name, _planted_run()) is None for name in METRICS)


@pytest.mark.parametrize("cell", sorted(smoke.CELLS))
def test_traced_smoke_run_reads_the_program_spans(cell):
    bench = smoke.bench()
    bench["per_layer"] = [dict(m, workloads=[cell]) for m in bench["per_layer"]
                          if m["name"] in METRICS]
    r = run_cell(bench, cell, smoke.SEED, 1.0, True, torch.device("cpu"),
                 time.perf_counter(), data=smoke.DATA)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == set(METRICS)
    # the CPU runs no device operation: every gap is the whole slice, which
    # opens outside the program's spans
    assert r["metrics"]["idle_decode_share"]["value"] == 0.0
    assert r["metrics"]["decode_host_ms"]["value"] > 0
    assert 0 < r["metrics"]["coherence_fill_share"]["value"] < 100
