"""The dry run's cells and their H100 accounting, on the CPU.

``configs.SHAPES`` / ``shape_cells`` / ``all_cells``, ``PerfOptions.tag``,
``_decode_geometry`` and ``model_flops`` against the reference's; every
argument of ``launch/specs.py:build_cell`` (built on the meta device) equal
in shape and dtype to the reference's ``build_cell`` on a one-device
``jax.make_mesh((1, 1), ("data", "model"))`` mesh, the reference's stacked
``[L, ...]`` leaves mapped onto the port's layers (and at model = 2 the
split leaves gathered back); the analytic counts of ``launch/analysis.py``
against what runs: a smoke step's FLOPs against ``FlopCounterMode``'s count
of the same step (products exactly, attention by its dense formula, as the
plain versions compute it on the CPU), the model axis's wire bytes against
``LoopPods``' counters; per-device bytes summed from each meta cell's
tensors against the count from the config's widths, for all 33 cells on
one pod and on two; the dry run's command line and its table, one
device's cut of a cell, the refusal of ``fused_ref``, and the cells of
every option case (``seq_parallel`` among them), whose smoke cells count
what they move.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.launch import analysis, dryrun, profile_cell, specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402

CELLS = jconfigs.all_cells()
OPTIONS = [dict(), dict(decode_kernel="fused_ref"), dict(bf16_grads=True),
           dict(seq_parallel=True), dict(coherence="eager"),
           dict(coherence="numapte", remat="dots", compress_pod_grads=True),
           dict(bf16_grads=True, seq_parallel=True, coherence="numapte")]


def test_torch_shapes_and_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in jconfigs.ARCH_IDS:
        assert tconfigs.shape_cells(arch) == jconfigs.shape_cells(arch)
    assert len(tconfigs.all_cells()) == len(CELLS) == 33
    assert sorted(tconfigs.all_cells()) == sorted(CELLS)


@pytest.mark.parametrize("kw", OPTIONS)
def test_torch_perf_options_tag_equals_the_reference(kw):
    assert specs.PerfOptions(**kw).tag() == jspecs.PerfOptions(**kw).tag()
    assert dataclasses.asdict(specs.PerfOptions(**kw)) == \
        dataclasses.asdict(jspecs.PerfOptions(**kw))


@pytest.mark.parametrize("data", [16, 32])
def test_torch_decode_geometry_equals_the_reference(data):
    for arch, shape in CELLS:
        want = jspecs._decode_geometry(jconfigs.get_config(arch),
                                       jconfigs.SHAPES[shape], data)
        got = specs._decode_geometry(tconfigs.get_config(arch),
                                     tconfigs.SHAPES[shape], data)
        assert got == want, (arch, shape)


@functools.lru_cache(maxsize=None)
def _reference_cell(arch, shape):
    """The reference's cell on a one-device mesh (shapes and dtypes of its
    arguments, by path) and its model FLOPs."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cell = jspecs.build_cell(arch, jconfigs.SHAPES[shape], mesh)
    leaves = {jax.tree_util.keystr(p): (tuple(l.shape), np.dtype(l.dtype).name)
              for p, l in jax.tree_util.tree_leaves_with_path(cell.args)}
    return leaves, janalysis.model_flops(jconfigs.get_config(arch),
                                         jconfigs.SHAPES[shape])


def _port_leaves(args):
    """The port's arguments keyed as the reference's: a layer's leaf under
    its group's stacked key, with the stacked shape [L, ...] (every layer
    of the group the same shape)."""
    out = {}

    def walk(node, key):
        if isinstance(node, torch.Tensor):
            out[key] = (tuple(node.shape), str(node.dtype).replace("torch.", ""))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}['{k}']")
        elif hasattr(node, "_fields"):
            for f, v in zip(node._fields, node):
                walk(v, f"{key}.{f}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{key}[{i}]")

    for i, arg in enumerate(args):
        if isinstance(arg, dict) and "groups" in arg:       # parameters
            _stacked(arg, f"[{i}]", out, walk)
        elif hasattr(arg, "mu"):                            # AdamW's state
            walk(arg.step, f"[{i}].step")
            for name in ("mu", "nu"):
                _stacked(getattr(arg, name), f"[{i}].{name}", out, walk)
        else:
            walk(arg, f"[{i}]")
    return out


def _stacked(params, key, out, walk):
    for k, v in params.items():
        if k != "groups":
            walk(v, f"{key}['{k}']")
    for g, layers in enumerate(params["groups"]):
        per_layer = [_port_leaves_of(lp) for lp in layers]
        assert all(p == per_layer[0] for p in per_layer)
        for sub, (shape, dtype) in per_layer[0].items():
            out[f"{key}['groups'][{g}]{sub}"] = ((len(layers),) + shape, dtype)


def _port_leaves_of(node, key=""):
    if isinstance(node, torch.Tensor):
        return {key: (tuple(node.shape), str(node.dtype).replace("torch.", ""))}
    out = {}
    for k, v in node.items():
        out.update(_port_leaves_of(v, f"{key}['{k}']"))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_torch_meta_cell_equals_the_reference(arch, shape):
    """Every argument in shape and dtype, and ``model_flops``."""
    want, want_flops = _reference_cell(arch, shape)
    grid = make_debug_mesh(1, device="meta")
    cell = specs.build_cell(arch, tconfigs.SHAPES[shape], grid)
    assert all(t.device.type == "meta" for t in tree_leaves(cell.args))
    assert _port_leaves(cell.args) == want
    assert analysis.model_flops(cell.cfg, cell.shape) == want_flops
    assert len(cell.shares) == len(tree_leaves(cell.args))
    assert set(cell.shares) == {1}


@pytest.mark.parametrize("arch,shape", [("yi_6b", "train_4k"),
                                        ("qwen3_moe_235b_a22b", "decode_32k"),
                                        ("mamba2_370m", "prefill_32k")])
def test_torch_meta_cell_at_model_two_gathers_to_the_reference(arch, shape):
    """At model = 2 the split leaves carry their [2, ...] shards; gathered
    back over the model axis they are the reference's (the decode state's
    split recurrent states too)."""
    want, _ = _reference_cell(arch, shape)
    grid = make_debug_mesh(1, model=2, device="meta")
    cell = specs.build_cell(arch, tconfigs.SHAPES[shape], grid)
    split = specs.split_leaves(cell.args[0])
    assert any(split)
    n_split = sum(split)
    params = specs.gather_params(cell.args[0], grid)
    args = (params,) + cell.args[1:]
    if hasattr(args[1], "mu"):
        args = (params, args[1]._replace(
            mu=specs.gather_params(args[1].mu, grid),
            nu=specs.gather_params(args[1].nu, grid))) + args[2:]
    if hasattr(args[1], "caches"):
        args = (params, _whole_state(args[1])) + args[2:]
    assert _port_leaves(args) == want
    assert sum(s == 2 for s in cell.shares) >= n_split


def _whole_state(state):
    """A decode state's split recurrent caches in their whole shapes: the
    SSD's h [L, t, B, H/t, n, P] -> [L, B, H, n, P], the conv tail
    [L, t, B, W-1, C/t] -> [L, B, W-1, C] (shapes only: meta tensors)."""
    caches = []
    for c in state.caches:
        c = dict(c)
        if "h" in c and c["h"].dim() == 6:
            c["h"] = c["h"].movedim(1, 2).flatten(2, 3)
        if "conv" in c and c["conv"].dim() == 5:
            c["conv"] = c["conv"].movedim(1, -2).flatten(-2)
        caches.append(c)
    return state._replace(caches=tuple(caches))


@pytest.mark.parametrize("pods", [1, 2])
def test_torch_per_device_bytes_equal_the_analytic_count(pods):
    """All 33 cells on the production grid ((pod,) data 16 x model 16), on
    the meta device: the bytes one device holds, summed from the cell's
    tensors over their shares, equal the count from the config's widths;
    every cell has its roofline terms, and the cells that do not fit one
    80 GB device are the trillion-parameter and 235B ones."""
    grid = dryrun.production_grid(multi_pod=pods == 2)
    too_big = set()
    for arch, shape in CELLS:
        cell = specs.build_cell(arch, tconfigs.SHAPES[shape], grid)
        assert cell.chips == 256 * pods
        got, want = analysis.per_device_bytes(cell), analysis.device_bytes(cell)
        assert abs(got - want) <= 1e-9 * want, (arch, shape, got, want)
        r = analysis.roofline(cell)
        assert r.flops > 0 and r.bytes > 0 and r.bound_s > 0, (arch, shape)
        assert r.dominant in ("compute", "memory", "collective")
        if not r.fits:
            too_big.add(arch)
    assert too_big == {"qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"}


SMOKE_SHAPES = {step: tconfigs.ShapeSpec(f"{step}_smoke", 24, 4, step)
                for step in ("train", "prefill", "decode")}


def _smoke_cell(arch, step, t, **opts):
    grid = make_debug_mesh(1, model=t, device="cpu")
    cfg = tconfigs.get_smoke_config(arch)
    return grid, specs.build_cell(arch, SMOKE_SHAPES[step], grid, cfg=cfg,
                                  device="cpu", opts=specs.PerfOptions(**opts))


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_torch_cell_counts_equal_what_runs(arch, step):
    """One smoke step on the CPU: FlopCounterMode's count equals
    ``step_flops`` with the attention counted densely (every (query, key)
    pair, every slot of a decode step's table: what the plain versions
    compute); at model = 2 on ``LoopPods`` the model axis's counted wire
    bytes equal ``model_wire``."""
    from torch.utils.flop_counter import FlopCounterMode
    _, cell = _smoke_cell(arch, step, 1)
    with FlopCounterMode(display=False) as fc:
        cell.step_fn(*cell.args)
    assert fc.get_total_flops() == sum(
        analysis.step_flops(cell, dense_attention=True).values())
    grid, cell = _smoke_cell(arch, step, 2)
    grid.model.reset_counters()
    cell.step_fn(*cell.args)
    assert grid.model.wire_bytes == analysis.model_wire(cell)
    if specs.split_leaves(cell.args[0]) and any(specs.split_leaves(cell.args[0])):
        assert analysis.model_wire(cell) > 0


@pytest.mark.parametrize("remat", [False, "full", "dots"])
def test_torch_train_flops_by_kind_and_remat(remat):
    """Yi-6B's smoke train step: the products are exactly the ``aten.mm``
    count and the attention (dense, on the CPU) exactly the ``aten.bmm``
    count; ``"full"`` recomputes every product but each layer's last,
    ``"dots"`` only the attention; the causal count is below the dense
    one."""
    from torch.utils.flop_counter import FlopCounterMode
    _, cell = _smoke_cell("yi_6b", "train", 1, remat=remat)
    with FlopCounterMode(display=False) as fc:
        cell.step_fn(*cell.args)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    dense = analysis.step_flops(cell, dense_attention=True)
    assert counts["aten.mm"] == dense["products"]
    assert counts["aten.bmm"] == dense["attention"]
    causal = analysis.step_flops(cell)
    assert causal["products"] == dense["products"]
    assert 0 < causal["attention"] < dense["attention"]
    assert analysis.cell_flops(cell) == sum(causal.values()) * cell.chips


def test_torch_visible_pairs():
    S, W = 10, 3
    mask = np.tril(np.ones((S, S), bool))
    assert analysis.visible_pairs(S, True, None) == mask.sum()
    band = mask & (np.arange(S)[:, None] - np.arange(S)[None, :] < W)
    assert analysis.visible_pairs(S, True, W) == band.sum()
    assert analysis.visible_pairs(S, False, None) == S * S


def test_torch_dryrun_command_writes_the_cell(tmp_path, capsys):
    dryrun.main(["--arch", "kimi_k2_1t_a32b", "--shape", "decode_32k",
                 "--multi-pod", "--coherence", "numapte", "--out",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert "[kimi_k2_1t_a32b x decode_32k x pod2x16x16__numapte]" in out
    assert "does not fit" in out and "all 1 cells" in out
    saved = json.loads((tmp_path / "kimi_k2_1t_a32b__decode_32k__"
                        "pod2x16x16__numapte.json").read_text())
    roof = saved["roofline"]
    assert roof["chips"] == 512 and not roof["fits"]
    assert roof["collectives"]["pod"] > 0
    assert saved["device_bytes"] == pytest.approx(roof["per_device_bytes"])


def test_torch_dryrun_refusals(tmp_path, capsys):
    """``fused_ref`` models the Pallas kernel's streaming (the port decodes
    with K1).  Megatron sequence parallelism builds: its cell on the meta
    device, the dry run's cell file tagged ``sp``, and a smoke cell whose
    model axis counts on the CPU what ``model_wire`` says; ``--table``
    prints the cells' roofline rows and writes them as ``roofline.csv``."""
    grid = make_debug_mesh(1, device="meta")
    shape = tconfigs.SHAPES["decode_32k"]
    with pytest.raises(ValueError, match="K1"):
        specs.build_cell("yi_6b", shape, grid,
                         opts=specs.PerfOptions(decode_kernel="fused_ref"))
    cell = specs.build_cell("yi_6b", shape, grid,
                            opts=specs.PerfOptions(seq_parallel=True))
    assert cell.seq_split == {"decoder": False}
    dryrun.main(["--arch", "yi_6b", "--shape", "train_4k", "--seq-parallel",
                 "--out", str(tmp_path)])
    saved = json.loads((tmp_path / "yi_6b__train_4k__pod16x16__sp.json")
                       .read_text())
    assert saved["mesh"] == "pod16x16__sp"
    dryrun.main(["--table", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "pod16x16__sp" in out and "roofline_frac" in out
    assert (tmp_path / "roofline.csv").read_text().count("\n") == 2
    grid, cell = _smoke_cell("yi_6b", "train", 2, seq_parallel=True)
    assert cell.seq_split == {"decoder": True}
    grid.model.reset_counters()
    cell.step_fn(*cell.args)
    assert grid.model.calls["reduce_scatter"] > 0
    assert grid.model.wire_bytes == analysis.model_wire(cell)
    with pytest.raises(ValueError, match="K1"):
        dryrun.main(["--arch", "yi_6b", "--shape", "decode_32k",
                     "--decode-kernel", "fused_ref"])


@pytest.mark.parametrize("kw", OPTIONS)
def test_torch_option_cells_build(kw):
    """Every option case builds its cells on the production grid (one pod
    and two), but ``fused_ref``, which the port refuses; the SP cells split
    their train and prefill stacks, never a decode step's."""
    opts = specs.PerfOptions(**kw)
    for pods in (1, 2):
        grid = dryrun.production_grid(multi_pod=pods == 2)
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            if kw.get("decode_kernel") == "fused_ref":
                with pytest.raises(ValueError, match="K1"):
                    specs.build_cell("yi_6b", tconfigs.SHAPES[shape], grid,
                                     opts=opts)
                continue
            cell = specs.build_cell("yi_6b", tconfigs.SHAPES[shape], grid,
                                    opts=opts)
            assert cell.seq_split == {"decoder": bool(
                opts.seq_parallel and shape != "decode_32k")}
            r = analysis.roofline(cell)
            assert r.mesh.endswith(opts.tag()) or opts.tag() == "base"
            assert r.bound_s > 0


def test_torch_card_cell_names_its_cuts():
    """One device's cut of Yi-6B's cells: a data shard's rows, the whole
    model, and for training the most layers whose analytic peak fits 90 %
    of the card (one more does not)."""
    cell = profile_cell.card_cell("yi_6b", "decode_32k", device="meta")
    assert cell.rows == 8 and cell.cfg.n_layers == 32
    assert set(cell.cuts) == {"model", "rows"}
    train = profile_cell.card_cell("yi_6b", "train_4k", rows=2, device="meta")
    L = train.cfg.n_layers
    assert 0 < L < 32 and "n_layers" in train.cuts
    budget = profile_cell.BUDGET * analysis.HBM_BYTES
    assert analysis.peak_bytes(train) <= budget
    more = profile_cell._cell("yi_6b", "train_4k", 2, L + 1,
                              specs.PerfOptions(), "meta")
    assert analysis.peak_bytes(more) > budget
