"""The port's logical-axis rules and parameter specs
(``repro_torch.distributed.sharding``, ``repro_torch.launch.specs``)
against the reference's (``repro.distributed.sharding``,
``repro.launch.specs``), for all ten configs at their published shapes
(shapes only: the reference's ``jax.eval_shape``, the port's meta tensors).

The mesh the reference's functions read is a stand-in with ``.axis_names``
and ``.shape``; the port's grid is ``make_debug_mesh`` on the CPU.  The
reference's tree stacks a group's layers on a leading axis, so its spec of
a group leaf is the port's with a leading None.  The two allowed
differences are rules of explicit tensor parallelism, asserted leaf by leaf
against predicates written out here: the whole-head rule
(``launch/specs.py:_whole_heads``: the port splits ``wq``/``wo`` only when t
divides H (and each shard's query heads share a kv head when t does not
divide K), and ``wk``/``wv`` only when t also divides K; GSPMD splits their
columns wherever t divides them), and the SSD's sectioned split
(``_ssd_split``: an SSD layer's ``ff`` leaves split together when t divides
its heads and its state width, ``in_proj`` and the conv by section; GSPMD
splits each leaf whose width t divides, contiguously).
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import tree_leaves_with_path  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.common import SHAPES_ONLY  # noqa: E402

ARCHS = tconfigs.ARCH_IDS
DENSE = ["qwen3_14b", "yi_6b", "nemotron_4_15b", "chameleon_34b"]
TP = [2, 4, 16]
SSD_LEAVES = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
              "out_proj")


def _mesh(multi_pod: bool, model: int = 16):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    shape = dict(zip(names, ((2,) if multi_pod else ()) + (16, model)))
    return types.SimpleNamespace(axis_names=names, shape=shape)


def _grid(multi_pod: bool, model: int = 16):
    return make_debug_mesh(2 if multi_pod else 1, data=16, model=model,
                           device="cpu")


def test_torch_rule_tables_are_the_references():
    assert tsh.SINGLE_POD_RULES.rules == jsh.SINGLE_POD_RULES.rules
    assert tsh.MULTI_POD_RULES.rules == jsh.MULTI_POD_RULES.rules
    assert tsh.FSDP_EXTRA_AXES == jsh.FSDP_EXTRA_AXES
    for name, _ in jsh.SINGLE_POD_RULES.rules:
        assert tsh.SINGLE_POD_RULES.lookup(name) == \
            jsh.SINGLE_POD_RULES.lookup(name)
    assert tsh.SINGLE_POD_RULES.lookup(None) is None
    assert tsh.SINGLE_POD_RULES.lookup("no_such_axis") is None


def test_torch_use_rules_nests_like_the_reference():
    inner = tsh.ShardingRules(rules=(("heads", None),))
    assert tsh.current_rules() is tsh.SINGLE_POD_RULES
    with tsh.use_rules(tsh.MULTI_POD_RULES):
        assert tsh.logical_spec("batch", "heads") == tuple(
            jsh.MULTI_POD_RULES.spec(("batch", "heads")))
        with tsh.use_rules(inner):
            assert tsh.logical_spec("batch", "heads") == (None, None)
        assert tsh.current_rules() is tsh.MULTI_POD_RULES
    assert tsh.current_rules() is tsh.SINGLE_POD_RULES


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_make_rules_equals_the_references(arch, multi_pod):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tcfg.rule_overrides == jcfg.rule_overrides
    want = jspecs.make_rules(jcfg, _mesh(multi_pod))
    assert specs.make_rules(tcfg, _grid(multi_pod)).rules == want.rules


def _reference_specs(arch: str, t: int):
    """{stacked path: (reference spec of the leaf, its shape)}."""
    jcfg = jconfigs.get_config(arch)
    mesh = _mesh(False, t)
    shapes = jax.eval_shape(lambda k: jm.init_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    out = {}
    with jsh.use_rules(jspecs.make_rules(jcfg, mesh)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            names = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)
            spec = jsh.param_pspec(names, leaf.shape)
            if len(spec) and len(leaf.shape) == len(spec) + 1:
                spec = jax.sharding.PartitionSpec(None, *spec)
            out[names] = (_norm(jspecs._divisible(leaf.shape, spec, mesh)),
                          tuple(leaf.shape))
    return out


def _norm(spec):
    """A spec with every one-axis tuple written as its axis (the reference's
    ``PartitionSpec`` writes ("model",) as "model")."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _port_leaves(arch: str):
    cfg = tconfigs.get_config(arch)
    return cfg, list(tree_leaves_with_path(tm.init_params(cfg, SHAPES_ONLY)))


def _stacked(path):
    """The reference's path of a port leaf: a group's layer index dropped."""
    return path[:2] + path[3:] if path[0] == "groups" else path


def _whole_head_spec(name, spec, cfg, t):
    """The port's rule, written out independently of launch/specs.py."""
    if name not in ("wq", "wk", "wv", "wo"):
        return spec
    H, K, G = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q_whole = H % t == 0 and (K % t == 0 or G % (H // t) == 0)
    kv_whole = q_whole and K % t == 0
    keep = q_whole if name in ("wq", "wo") else kv_whole
    return spec if keep else (None,) * len(spec)


@pytest.mark.parametrize("t", TP)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_param_specs_equal_the_references(arch, t):
    """param_pspec + _divisible of every leaf equals the reference's spec of
    its stacked leaf (its leading layer axis dropped)."""
    want = _reference_specs(arch, t)
    cfg, leaves = _port_leaves(arch)
    grid = make_debug_mesh(1, data=16, model=t, device="cpu")
    seen = set()
    with tsh.use_rules(specs.make_rules(cfg, grid)):
        for path, leaf in leaves:
            spec = specs._divisible(tuple(leaf.shape),
                                    tsh.param_pspec(path, tuple(leaf.shape)),
                                    grid)
            ref, ref_shape = want[_stacked(path)]
            if path[0] == "groups":
                assert ref[0] is None and ref_shape[1:] == tuple(leaf.shape)
                ref = ref[1:]
            assert _norm(spec) == ref, (path, spec, ref)
            seen.add(_stacked(path))
    assert seen == set(want)


def _ssd_spec(path, leaf, cfg, t):
    """The port's SSD rule, written out independently of launch/specs.py:
    the layer's ff leaves on the model axis when t divides H and n, their
    spec then ff's split dimension; None where the leaf is no SSD leaf."""
    if len(path) < 2 or path[-2] != "ssd" or path[-1] not in SSD_LEAVES:
        return None
    ff_dim = {"in_proj": 1, "conv_w": 1, "out_proj": 0}.get(path[-1], 0)
    spec = [None] * len(leaf.shape)
    if cfg.ssm_n_heads % t == 0 and cfg.ssm_state % t == 0:
        spec[ff_dim] = "model"
    return tuple(spec)


@pytest.mark.parametrize("t", TP)
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_param_shardings_split_whole_heads(arch, t):
    """param_shardings = the reference's spec, except the whole-head rule
    and the SSD's sectioned split; the leaves where the port's spec differs
    are the ones the whole-head rule names (Yi-6B's 4 kv heads at t = 16,
    Qwen3-14B's 40 heads at t = 16, the MoE configs' 4 and 8 kv heads at
    t = 16, ...; none where the config's rules replicate the heads), and
    the leaves split by section are Mamba-2's in_proj, conv_w and conv_b
    (whose widths, published, t divides: their spec is the reference's)."""
    want = _reference_specs(arch, t)
    cfg, leaves = _port_leaves(arch)
    grid = make_debug_mesh(1, data=16, model=t, device="cpu")
    tree = specs.param_shardings(tm.init_params(cfg, SHAPES_ONLY), grid, cfg)
    got = dict(_shard_leaves(tree))
    differ, sectioned = set(), set()
    for path, leaf in leaves:
        ref = want[_stacked(path)][0]
        ref = ref[1:] if path[0] == "groups" else ref
        expect = _ssd_spec(path, leaf, cfg, t) or _whole_head_spec(
            path[-1], ref, cfg, t)
        if expect != ref:
            differ.add(path[-1])
        dims = [d for d, a in enumerate(expect) if a is not None]
        shard = got[path]
        if shard is not None and shard.sections:
            sectioned.add(path[-1])
            assert sum(shard.sections) == leaf.shape[shard.dim], path
        if not dims:
            assert shard is None, path
        else:
            assert shard[:2] == (dims[0], "model"), (path, shard)
    H, K = cfg.n_heads, cfg.n_kv_heads
    heads_on_model = jspecs.make_rules(
        jconfigs.get_config(arch), _mesh(False, t)).lookup("heads") is not None
    if not heads_on_model or cfg.family == "ssm":
        assert not differ            # Gemma-3, RecurrentGemma, Whisper
    elif H % t:                      # e.g. Qwen3-14B's 40 heads at t = 16
        assert differ == {"wq", "wk", "wv", "wo"}
    elif K % t:                      # e.g. Yi-6B's 4 kv heads at t = 16
        assert differ == {"wk", "wv"}
    else:
        assert not differ
    assert sectioned == ({"in_proj", "conv_w", "conv_b"}
                         if cfg.family == "ssm" else set())


def _shard_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shard_leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _shard_leaves(v, path + (str(i),))
    else:
        yield path, tree


@pytest.mark.parametrize("t", [2, 4])
def test_torch_kv_layout_follows_the_rules(t):
    """Every config's own rules keep the paged slabs replicated over the
    model axis; SINGLE_POD_RULES' default (kv_heads on model) splits them
    where t divides K."""
    for arch in DENSE:
        cfg = tconfigs.get_config(arch)
        grid = make_debug_mesh(1, model=t, device="cpu")
        assert specs.kv_split(cfg, grid) == 1
        split = specs.kv_split(cfg, grid, tsh.SINGLE_POD_RULES)
        assert split == (t if cfg.n_kv_heads % t == 0 else 1)
    yi = tconfigs.get_config("yi_6b")          # 4 kv heads
    assert specs.kv_split(yi, make_debug_mesh(1, model=16, device="cpu"),
                          tsh.SINGLE_POD_RULES) == 1


def test_torch_shard_and_gather_are_inverse():
    """shard_params splits a leaf into [t, ...] slices in shard order and
    gather_params rebuilds it bit for bit; split_leaves marks exactly the
    split leaves."""
    cfg = tconfigs.get_smoke_config("qwen3_14b")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    grid = make_debug_mesh(1, model=2, device="cpu")
    sharded = specs.shard_params(params, grid, cfg)
    attn = params["groups"][0][0]["attn"]
    sattn = sharded["groups"][0][0]["attn"]
    assert sattn["wq"].shape == (2, 64, 32)
    assert torch.equal(sattn["wq"][1], attn["wq"][:, 32:])
    assert torch.equal(sattn["wo"][1], attn["wo"][32:])
    assert sharded["embedding"].shape == (2, 256, 64)
    assert sharded["final_norm"]["scale"] is params["final_norm"]["scale"]
    flags = specs.split_leaves(sharded)
    assert sum(flags) == 2 + 2 * 7 and not any(specs.split_leaves(params))
    back = specs.gather_params(sharded, grid)
    for (p1, a), (p2, b) in zip(tree_leaves_with_path(back),
                                tree_leaves_with_path(params)):
        assert p1 == p2 and torch.equal(a, b)
    assert np.isfinite(float(sharded["lm_head"].sum()))
