"""The latent-attention MoE configuration (Moonlight-16B-A3B's block): its
plain reference against the program, its bound, its readers, and a cell of
it served on the CPU through the harness."""
import json

import pytest
import torch

from repro_torch.models.transformer import forward_lm

from perfbench import mla_bound
from perfbench.portspans import PortSpans
from perfbench.harness import Run, load_module, program_config
from perfbench.reference import mla_moe
from perfbench.tests import smoke
from perfbench.tracing import Spans, TraceSlice

CONF = json.loads((smoke.DATA / "configs" / "smoke_mla.json").read_text())
CELL = {"name": "mla.backlog", "config": "smoke_mla", "traffic": "tiny_backlog",
        "chips": 1, "why": "test"}


def test_reference_matches_program_float32():
    model = CONF["model"]
    w = mla_moe.make_weights(model, 2 ** 31 + 5, "cpu")
    cfg = program_config({"name": "t", "model": model})
    assert cfg.mla and cfg.moe_dropless and cfg.moe_router == "sigmoid"
    tokens = torch.randint(0, 512, (2, 40), generator=torch.Generator().manual_seed(1))
    want, _ = forward_lm(cfg, mla_moe.port_params(model, w), tokens, remat=False)
    got = mla_moe.logits(model, w, list(tokens), [range(40)] * 2)
    for g, x in zip(got, want):
        assert torch.allclose(g, x.float(), atol=1e-4, rtol=1e-4)


def test_weights_seeded_and_scaled():
    model = dict(CONF["model"], dtype="bfloat16")
    a = mla_moe.make_weights(model, 7, "cpu")
    b = mla_moe.make_weights(model, 7, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["we_in"].shape == (2, 8, 64, 32) and a["kv_norm"].shape == (3, 64)
    assert a["w_kv_b"].shape == (3, 64, 4 * 32) and a["router_bias"].shape == (2, 8)
    assert a["router_bias"].float().std().item() == pytest.approx(0.05, rel=0.6)


def test_mla_bound_by_hand():
    # 2 rows, 16 heads, latent 512 + 64, 10 columns, 3 000 live slots
    nbytes = 3000 * 576 * 2 + 2 * 16 * 576 * 2 + 2 * 16 * 512 * 4 + 2 * 10 * 4 + 2 * 4
    flops = 2 * 16 * 1088 * 3000
    assert mla_bound.mla_bound(2, 16, 512, 64, 10, 3000) == pytest.approx(
        max(nbytes / 3.35e12, flops / 989e12))
    assert nbytes / 3.35e12 > flops / 989e12       # K4 is bound by bytes


def test_readers_read_nothing_without_their_source():
    run = Run(CONF["model"], {"batch": 4}, 1.0, 0.0, 0.0, 1.0, 0.0, [], [], [],
              Spans(), 4)
    for name in ("mla_roofline", "moe_prefill_ms"):
        assert load_module(smoke.HERE.parent / "metrics", name).read(run) is None
    # a slice whose K4 count is not steps x layers reads nothing
    run.trace = TraceSlice(0, 10, [("mla_decode_kernel<512, 64>", 0, 5)], [],
                           step_lens=[(40,) * 4])
    assert load_module(smoke.HERE.parent / "metrics", "mla_roofline").read(run) is None
    run.trace.ops = [("mla_decode_kernel<512, 64>", 0, 5)] * 3
    got = load_module(smoke.HERE.parent / "metrics", "mla_roofline").read(run)
    assert got == pytest.approx(100.0 * 3 * mla_bound.mla_bound(
        4, 4, 64, 16, 4, 160, "float32") / 15e-9)


def test_moe_prefill_ms_is_the_device_time_inside_prefill_moe_spans():
    run = Run(CONF["model"], {"batch": 4}, 1.0, 0.0, 0.0, 1.0, 0.0, [], [], [],
              Spans(), 4)
    # a prefill's two MoE layers at [100, 200) and [300, 400), a decode
    # step's at [600, 700); operations on two streams, one across an edge
    run.trace = TraceSlice(0, 1000, [("a", 90, 30), ("b", 150, 20),
                                     ("c", 160, 20), ("d", 320, 70),
                                     ("e", 600, 100), ("f", 450, 10)], [])
    run._port_spans = PortSpans(
        ["prefill", "layer", "moe", "layer", "moe", "decode", "moe"],
        [-1, 0, 1, 0, 3, -1, 5], [50, 90, 100, 290, 300, 550, 600],
        [500, 250, 200, 450, 400, 800, 700], [{}] * 7, [], 1000)
    got = load_module(smoke.HERE.parent / "metrics", "moe_prefill_ms").read(run)
    # 20 of a's 30 ns and b, c's union of 30 in the first; d's 70 in the second
    assert got == pytest.approx(1e-6 * (50 + 70) / 2)
    run.trace.ops = []
    assert load_module(smoke.HERE.parent / "metrics",
                       "moe_prefill_ms").read(run) is None


def test_cell_served_on_the_cpu():
    r = smoke.run("mla.backlog", extra=[CELL])
    assert r["correct"], r["checks"]
    assert r["compared_tokens"] > 0
    assert {"tok_per_s", "itl_p95_ms", "setup_s"} == set(r["metrics"])


def test_traced_cell_reports_the_new_metrics_only_where_listed():
    bench = smoke.bench([CELL])
    names = [m["name"] for m in bench["per_layer"]
             if "workloads" in m and "moonlight16b.decode_backlog64" in m["workloads"]]
    assert names == ["mla_roofline", "moe_prefill_ms"]
    r = smoke.run("mla.backlog", extra=[CELL], trace=True)
    assert r["correct"], r["checks"]
    # the CPU has no device operations and no CUDA events: both read nothing
    assert not {"mla_roofline", "moe_prefill_ms"} & set(r["metrics"])
