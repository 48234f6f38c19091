"""``BENCHMARK.json`` against the benchmark's contract, and the files the
harness finds by the names in it."""
import json
import re
from pathlib import Path

import pytest

from perfbench import traffic
from perfbench.harness import load_module

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1:] == ["perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43 200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in [c["name"] for c in BENCH["configs"]]
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        names.append(m["name"])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    def reported(kind):
        return [m for m in BENCH[kind]
                if "workloads" not in m or cell in m["workloads"]]
    e2e = {m["name"] for m in reported("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = reported("per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(load_module(ROOT / "perfbench" / "metrics", metric).read)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(cell):
    conf = json.loads((ROOT / "perfbench" / "configs" /
                       f"{cell['config']}.json").read_text())
    assert conf["reduced"] == [] and conf["model"]["dtype"] == "bfloat16"
    assert set(conf["limits"]) == {"logit_gap", "replica_stale",
                                   "frame_conflicts", "replica_mismatch"}
    assert (ROOT / "perfbench" / "reference" / f"{conf['reference']}.py").is_file()
    mix = traffic.load(cell["traffic"])
    assert mix["prompt_len"] + mix["gen_len"] <= conf["model"]["context_length"]
