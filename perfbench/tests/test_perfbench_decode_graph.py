"""``decode_graph_share`` on the planted slice of
``test_perfbench_port_spans.py`` with its ``decode`` records given
``graph`` counts, without them (a program that does not graph the step),
and on a traced smoke run (the CPU: every step eager)."""
import dataclasses
import time

import pytest
import torch

from perfbench.harness import HERE, load_module, run_cell
from perfbench.tests import smoke
from perfbench.tests.test_perfbench_port_spans import (_planted_run,
                                                       _port_records)
from repro_torch import tracing

NAME = "decode_graph_share"


def _read(run):
    return load_module(HERE / "metrics", NAME).read(run)


def _with_graph(*flags):
    """The planted records, the slice's decode spans counting ``flags``."""
    def records():
        recs, it = _port_records(), iter(flags)
        return [dataclasses.replace(r, counts={"graph": next(it)})
                if r.name == "decode" else r for r in recs]
    return records


@pytest.mark.parametrize("flags,want", [((1, 1), 100.0), ((0, 1), 50.0),
                                        ((0, 0), 0.0)])
def test_planted_share(monkeypatch, flags, want):
    monkeypatch.setattr(tracing, "records", _with_graph(*flags))
    assert _read(_planted_run()) == pytest.approx(want)


def test_nothing_to_read(monkeypatch):
    # decode spans without the count: the program before it graphed the step
    monkeypatch.setattr(tracing, "records", _port_records)
    assert _read(_planted_run()) is None
    # decode spans that do not number the slice's steps; no trace
    monkeypatch.setattr(tracing, "records", _with_graph(1, 1))
    assert _read(_planted_run(step_lens=((9,),))) is None
    run = _planted_run()
    run.trace = None
    assert _read(run) is None


@pytest.mark.parametrize("cell", sorted(smoke.CELLS))
def test_traced_smoke_run_is_eager(cell):
    bench = smoke.bench()
    bench["per_layer"] = [dict(m, workloads=[cell]) for m in bench["per_layer"]
                          if m["name"] == NAME]
    r = run_cell(bench, cell, smoke.SEED, 1.0, True, torch.device("cpu"),
                 time.perf_counter(), data=smoke.DATA)
    assert r["correct"], r["checks"]
    assert r["metrics"][NAME]["value"] == 0.0
