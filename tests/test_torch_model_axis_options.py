"""The grid's options over the model and data axes, on the CPU: pool-
partitioned KV and sequence-parallel decode over the model axis, the data
axis over the caches held a row, the int8 pod leg with the model axis split
across processes, and the dry run's decode and prefill cells on a real
(pods 2, data 2, model 2) grid.

  * **Pooled KV** (two pools, rows 0-1 in pool 0, rows 2-3 in pool 1, row
    3 padding, frames local to each): every decoder-only family of
    ``test_torch_model_axis_families`` at model 2 under its smoke rules (kv
    heads split: the pooled-and-split layout ``[L, t, P, F/P, bt, Ks,
    hd]``) and under the published rules (the slabs replicated, each shard
    its kv heads), and at model 4 (one kv head a shard), prefill + 3
    decode steps against the reference's no-mesh pooled ``prefill`` /
    ``decode_step`` (relative 1e-4 of the largest logit, jitted once per
    arch) and against the port's pooled model-1 run (1e-5).
  * **Sequence-parallel decode at model 2** (Qwen3-14B's smoke config, the
    slabs moved into the SP column layout as ``test_torch_pooled`` does:
    the reference's pooled prefill uses the other layout, ROADMAP queue 3),
    kv heads split and replicated, over ``LoopPods(2)`` pods: against the
    reference's ``decode_step(sp=True)`` (1e-4) and the port's model-1 SP
    (1e-5); an SP cell's pod and model bytes equal ``analysis``' counts.
  * **Data 2 against data 1** at model 1 and 2 for Gemma-3 (rings),
    RecurrentGemma (rings, ``h``, ``conv``), Mamba-2 (``h``, ``conv``) and
    Whisper (cross K/V): logits within 1e-5 and every cache held a row
    within 1e-5 of data 1's after the prefill and each step; the control,
    a shard writing rows 0..B/d-1 of the whole cache, must miss.
  * **The int8 leg across processes** (``DistPods`` on gloo at world 2 as
    the model axis, ``LoopPods(2)`` the pod axis): loss, gradients, error
    buffers and updated weights of two steps bit for bit those of
    ``LoopPods`` (2, model 2); and a split leaf's int8 payload, quantized
    one shard at a time, equal to the whole leaf's (without the model
    axis's ``pmax`` it is not).
  * **The cells**: every arch's smoke decode and prefill cell on a real
    (2, 2, 2) CPU grid gives the tokens and caches of its grid-of-one run
    (float32), and the model and pod axes' ``Pods`` counters equal
    ``analysis.cell_wire_bytes``.

Float32 smoke configs throughout (the reference's weights through
``params_from_jax``, norms perturbed, as in ``test_torch_models``).
"""
from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.distributed import LoopPods  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.launch import analysis, specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.transformer import gather_vocab, vocab_split  # noqa: E402
from test_torch_model_axis import ROOT  # noqa: E402
from test_torch_model_axis_families import LAYOUT, _rel, _rules  # noqa: E402
from test_torch_models import _setup  # noqa: E402

DECODERS = ["gemma3_4b", "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b",
            "mamba2_370m", "recurrentgemma_2b"]
CASES = [(2, "rules"), (2, "published"), (4, "rules")]
REF_REL = 1e-4
OWN_TOL = 1e-5
B, P, S, STEPS = 4, 2, 21, 3


def _geometry(jcfg):
    bt = jcfg.kv_block_tokens
    MB = (S + STEPS + bt - 1) // bt + 1
    F = 2 * MB + 1                     # frames a pool (two rows and a spare)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    tables = np.full((B, MB), -1, np.int32)
    for pool in range(P):
        frames = rng.permutation(F)
        for j, b in enumerate(range(pool * B // P, (pool + 1) * B // P)):
            tables[b] = frames[j * MB:(j + 1) * MB]
    tables[-1] = -1                                  # a padding row
    return tokens, tables, MB, F


@functools.lru_cache(maxsize=None)
def _reference_pooled(arch):
    """The reference's no-mesh pooled prefill + STEPS decode steps (fed its
    own greedy tokens): the logits of each, and the tokens."""
    jcfg, _, jparams, _ = _setup(arch, "f32")
    tokens, tables, MB, F = _geometry(jcfg)
    state = jm.init_decode_state(jcfg, B, P * F, MB, n_pools=P)
    lg, state = jax.jit(functools.partial(jm.prefill, jcfg))(
        jparams, jnp.asarray(tokens), state, jnp.asarray(tables))
    decode = jax.jit(functools.partial(jm.decode_step, jcfg, kernel="ref"))
    logits, fed = [np.asarray(lg)], []
    for _ in range(STEPS):
        tok = jm.greedy_sample(lg)
        fed.append(np.array(tok))
        lg, state = decode(jparams, state, tok, jnp.asarray(tables))
        logits.append(np.asarray(lg))
    return logits, fed


@functools.lru_cache(maxsize=None)
def _port_pooled(arch, t, layout="rules"):
    """The port's pooled prefill + decode steps (fed the reference's
    tokens) on a model axis of t (1: no grid), the logits whole; and the
    state's layout."""
    jcfg, tcfg, _, tparams = _setup(arch, "f32")
    tokens, tables, MB, F = _geometry(jcfg)
    _, fed = _reference_pooled(arch)
    grid = make_debug_mesh(1, model=t, device="cpu")
    tp = grid.model if t > 1 else None
    rules = _rules(tcfg, arch, grid, layout)
    params = specs.shard_params(tparams, grid, tcfg, rules)
    whole = ((lambda lg: gather_vocab(lg, tp))
             if tp is not None and vocab_split(params) else (lambda lg: lg))
    state = tm.init_decode_state(
        tcfg, B, P * F, MB, n_pools=P, device="cpu",
        kv_split=specs.kv_split(tcfg, grid, rules) if t > 1 else 1,
        state_split=specs.state_split(params, grid) if t > 1 else 1)
    phys = torch.from_numpy(tables)
    with torch.no_grad():
        lg, state = tm.prefill(tcfg, params, torch.from_numpy(tokens), state,
                               phys, tp=tp)
        logits = [whole(lg).numpy()]
        for tok in fed:
            lg, state = tm.decode_step(tcfg, params, state,
                                       torch.from_numpy(tok), phys, tp=tp)
            logits.append(whole(lg).numpy())
    return logits, state.layout


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", DECODERS)
def test_torch_pooled_kv_over_the_model_axis(arch, t, layout):
    """Pooled KV at model t against the reference's no-mesh pooled forms
    and the port's pooled model-1 run; the layout says how the slabs are
    held (split by kv head where the rules put them on the model axis and
    t divides K)."""
    ref, _ = _reference_pooled(arch)
    one, _ = _port_pooled(arch, 1)
    got, lay = _port_pooled(arch, t, layout)
    assert (lay.pools, lay.kv_split, lay.state_split) == (
        P,) + LAYOUT[arch][CASES.index((t, layout))]
    for step, (g, w, o) in enumerate(zip(got, ref, one)):
        assert _rel(g[:B - 1], w[:B - 1]) <= REF_REL, step
        assert np.abs(g[:B - 1] - o[:B - 1]).max() <= OWN_TOL, step


def test_torch_pooled_split_slab_is_one_operand_a_shard():
    """``[L, t, P, F/P, bt, Ks, hd]``: shard i's pools, flattened, are one
    contiguous view holding its kv heads of every pool."""
    cfg = tconfigs.get_smoke_config("qwen3_14b")
    state = tm.init_decode_state(cfg, 4, 12, 3, n_pools=2, kv_split=2,
                                 device="cpu")
    slab = state.caches[0]["k_slabs"]
    L, bt, hd = cfg.n_layers, cfg.kv_block_tokens, cfg.resolved_head_dim
    assert tuple(slab.shape) == (L, 2, 2, 6, bt, 1, hd)
    slab.copy_(torch.arange(slab.numel(), dtype=slab.dtype).view(slab.shape))
    for i in range(2):
        op = state.layout.shard_slab(slab[0], i)
        assert op.is_contiguous() and tuple(op.shape) == (12, bt, 1, hd)
        assert torch.equal(op[6:], slab[0, i, 1])
    with pytest.raises(ValueError, match="pools"):
        tm.init_decode_state(cfg, 4, 13, 3, n_pools=2, device="cpu")


# ------------------------------------------------------------------ SP decode
SP_STEPS, SP_PODS = 3, 2


def _sp_state(tcfg, tparams, n, kv):
    """A prompt prefilled into a one-pool state at model 1, then moved into
    the SP column layout over n pools (column c of a row in pool c // (MB
    / n)), its kv heads split over kv shards where kv > 1.  Returns (first
    token, SP state, pool-local tables)."""
    bt = tcfg.kv_block_tokens
    MB = -(-(-(-(S + SP_STEPS) // bt) + 1) // n) * n
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    tables = rng.permutation(2 * MB).astype(np.int32).reshape(2, MB)
    one = tm.init_decode_state(tcfg, 2, 2 * MB, MB, device="cpu")
    with torch.no_grad():
        logits, one = tm.prefill(tcfg, tparams, torch.from_numpy(tokens), one,
                                 torch.from_numpy(tables))
    F, MBl = 2 * MB // n, MB // n
    sp = tm.init_decode_state(tcfg, 2, n * F, MB, n_pools=n, kv_split=kv,
                              device="cpu")
    local = np.full_like(tables, -1)
    for name in ("k_slabs", "v_slabs"):
        src = one.caches[0][name]                         # [L, N, bt, K, hd]
        moved = torch.zeros((src.shape[0], n, F) + tuple(src.shape[2:]))
        for s in range(n):
            cols = tables[:, s * MBl:(s + 1) * MBl].reshape(-1)
            local[:, s * MBl:(s + 1) * MBl] = np.arange(cols.size).reshape(2, MBl)
            moved[:, s, :cols.size] = src[:, torch.from_numpy(cols).long()]
        if kv > 1:                          # [L, P, F, bt, K, hd] -> [L, t, P, F, bt, Ks, hd]
            L, _, _, bt_, K, hd = moved.shape
            moved = moved.view(L, n, F, bt_, kv, K // kv, hd).permute(
                0, 4, 1, 2, 3, 5, 6)
        sp.caches[0][name].copy_(moved)
    return tm.greedy_sample(logits), sp._replace(seq_lens=one.seq_lens.clone()), local


@functools.lru_cache(maxsize=None)
def _sp_run(t, layout):
    """SP decode of Qwen3-14B's smoke config over LoopPods(SP_PODS) at model
    t, fed the reference's tokens; and the reference's own no-mesh SP
    decode from the same state.  Returns (port logits, reference logits)."""
    arch = "qwen3_14b"
    jcfg, tcfg, jparams, tparams = _setup(arch, "f32")
    grid = make_debug_mesh(1, model=t, device="cpu")
    tp = grid.model if t > 1 else None
    rules = _rules(tcfg, arch, grid, layout)
    params = specs.shard_params(tparams, grid, tcfg, rules)
    kv = specs.kv_split(tcfg, grid, rules) if t > 1 else 1
    tok, sp, local = _sp_state(tcfg, tparams, SP_PODS, kv)
    whole = ((lambda lg: gather_vocab(lg, tp))
             if tp is not None and vocab_split(params) else (lambda lg: lg))
    if kv > 1:                              # the reference reads [L, P, F, bt, K, hd]
        gathered = [{n: c[n].permute(0, 2, 3, 4, 1, 5, 6).flatten(4, 5)
                     for n in c} for c in sp.caches]
    else:
        gathered = sp.caches
    jstate = jm.DecodeState(tuple({k: jnp.asarray(v.numpy()) for k, v in c.items()}
                                  for c in gathered), jnp.asarray(sp.seq_lens))
    jdecode = jax.jit(functools.partial(jm.decode_step, jcfg, sp=True))
    pods = LoopPods(SP_PODS, "cpu")
    got, want = [], []
    jtok = jnp.asarray(tok)
    with torch.no_grad():
        for _ in range(SP_STEPS):
            jl, jstate = jdecode(jparams, jstate, jtok, jnp.asarray(local))
            lg, sp = tm.decode_step(tcfg, params, sp, torch.from_numpy(
                np.array(jtok)), torch.from_numpy(local), sp=True, pods=pods,
                tp=tp)
            got.append(whole(lg).numpy())
            want.append(np.asarray(jl))
            jtok = jm.greedy_sample(jl)
    return got, want, sp.layout


@pytest.mark.parametrize("layout", ["rules", "published"])
def test_torch_sp_decode_over_the_model_axis(layout):
    """Each model shard decodes its heads over the pods (its kv heads of
    the pools, K1 with ``kv_heads`` and ``lse``, the combine of its
    partials), the row-parallel ``wo`` summed over the model axis."""
    got, want, lay = _sp_run(2, layout)
    one, _, _ = _sp_run(1, "rules")
    assert lay.kv_split == (2 if layout == "rules" else 1)
    for step, (g, w, o) in enumerate(zip(got, want, one)):
        assert _rel(g, w) <= REF_REL, step
        assert np.abs(g - o).max() <= OWN_TOL, step


@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma3_4b"])
def test_torch_sp_decode_cell_wire_equals_the_count(arch):
    """An SP decode cell (one row over 2 pods) at model 2: the pod axis's
    counted bytes equal ``analysis.sp_combine_wire`` (each shard's combine
    of its heads; Gemma-3's global layers at its smoke rules), the model
    axis's ``model_wire``, and the step's tokens those of model 1."""
    shape = tconfigs.ShapeSpec("decode_sp", 40, 1, "decode")
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype=torch.float32)
    toks = {}
    for t in (1, 2):
        grid = make_debug_mesh(2, model=t, device="cpu")
        cell = specs.build_cell(arch, shape, grid, cfg=cfg, device="cpu")
        assert cell.shares[-2:] == [1, 2]            # tokens, tables
        grid.reset_counters()
        grid.model.reset_counters()
        with torch.no_grad():
            toks[t], _ = cell.step_fn(*cell.args)
        wire = analysis.cell_wire_bytes(cell)
        assert grid.wire_bytes == wire["pod"] == analysis.sp_combine_wire(cell) * t > 0
        assert grid.model.wire_bytes == analysis.model_wire(cell)
    assert torch.equal(toks[1], toks[2])


# ------------------------------------------------------------------ data axis
ROW_ARCHS = ["gemma3_4b", "recurrentgemma_2b", "mamba2_370m", "whisper_base"]
ROW_CACHES = ("ring_k", "ring_v", "h", "conv", "cross_k", "cross_v")
SE = 12


def _rows_of(state):
    """A copy of every cache held a row, by (group, name)."""
    return {(g, name): t.clone() for g, cache in enumerate(state.caches)
            for name, t in cache.items() if name in ROW_CACHES}


def _data_run(arch, data, model, control=False):
    """Prefill + 2 decode steps of 4 rows over (data, model): each step's
    whole logits and the caches held a row after it."""
    jcfg, tcfg, _, tparams = _setup(arch, "f32")
    grid = make_debug_mesh(1, data=data, model=model, device="cpu")
    params = specs.shard_params(tparams, grid, tcfg)
    bt = tcfg.kv_block_tokens
    MB = (S + 2 + bt - 1) // bt + 1
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, S)).astype(np.int32))
    phys = torch.from_numpy(rng.permutation(4 * MB).astype(np.int32).reshape(4, MB))
    encdec = tcfg.family == "encdec"
    state = tm.init_decode_state(tcfg, 4, 4 * MB, MB, enc_len=SE if encdec else 0,
                                 kv_split=specs.kv_split(tcfg, grid),
                                 state_split=specs.state_split(params, grid),
                                 device="cpu")
    tp = grid.model if model > 1 else None
    whole = ((lambda lg: gather_vocab(lg, tp))
             if tp is not None and vocab_split(params) else (lambda lg: lg))
    real = specs._data_share
    if control:          # every shard handed rows 0..B/d-1 of the whole cache
        specs._data_share = lambda st, rows, n, pooled=True: real(
            st, slice(0, rows.stop - rows.start), n, pooled)._replace(
                seq_lens=st.seq_lens[rows])
    out = []
    try:
        with torch.no_grad():
            if encdec:
                feats = torch.from_numpy(rng.standard_normal(
                    (4, SE, tcfg.d_model)).astype(np.float32))
                tokens = tokens[:, :4]
                step = specs.build_prefill_step(tcfg, pods=grid)
                tok, state = step(params, state, feats, tokens, phys)
                lg = None
            else:
                lg, state = specs.prefill_on_grid(tcfg, params, tokens, state,
                                                  phys, grid)
                tok = specs.grid_sampler(params, grid)(lg)
            out.append((None if lg is None else whole(lg).numpy(),
                        _rows_of(state)))
            for _ in range(2):
                lg, state = specs.decode_on_grid(tcfg, params, state, tok,
                                                 phys, grid)
                tok = specs.grid_sampler(params, grid)(lg)
                out.append((whole(lg).numpy(), _rows_of(state)))
    finally:
        specs._data_share = real
    return out


def _equal_runs(got, want) -> bool:
    for (lg, caches), (lw, cw) in zip(got, want):
        if lg is not None and np.abs(lg - lw).max() > OWN_TOL:
            return False
        if set(caches) != set(cw) or not caches:
            return False
        if any(float((caches[k] - cw[k]).abs().max()) > OWN_TOL for k in cw):
            return False
    return True


@pytest.mark.parametrize("model", [1, 2])
@pytest.mark.parametrize("arch", ROW_ARCHS)
def test_torch_data_axis_over_caches_held_a_row(arch, model):
    """Data 2 serves its rows through views of the rings, ``h`` / ``conv``
    and cross K/V: logits and every cache held a row equal data 1's; a
    shard writing rows 0..B/d-1 of the whole cache (the control) does
    not."""
    want = _data_run(arch, 1, model)
    assert _equal_runs(_data_run(arch, 2, model), want)
    assert not _equal_runs(_data_run(arch, 2, model, control=True), want)


def test_torch_pool_share_of_a_data_shard():
    """A data shard's rows hold whole pools or lie in one; otherwise its
    rows would map onto other pools than the batch's do."""
    assert specs._pool_share(4, 8, slice(4, 8)) == slice(2, 4)
    assert specs._pool_share(2, 8, slice(2, 4)) == slice(0, 1)
    assert specs._pool_share(1, 8, slice(2, 4)) is None
    with pytest.raises(ValueError, match="whole pools"):
        specs._pool_share(4, 12, slice(0, 2))


# ------------------------------------------------------------------ int8 leg
WORKER = r'''
import sys, dataclasses, numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import DistPods, LoopPods
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_params
from repro_torch.optim import adamw_init

T, STEPS = 2, 2


def run(grid):
    """Two int8-leg train steps of the pods' average over the grid: each
    step's loss, the second step's gradients (this process's shards) and
    error buffers, and the updated weights."""
    cfg = dataclasses.replace(get_smoke_config("yi_6b"), dtype=torch.float32)
    params = specs.shard_params(init_params(
        cfg, torch.Generator().manual_seed(0)), grid, cfg)
    opt, ef = adamw_init(params), None
    step = specs.build_train_step(cfg, compress_pod_grads=True, pods=grid,
                                  remat=False)
    rng = np.random.default_rng(0)
    out = {}
    for i in range(STEPS):
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 17)).astype(np.int32))
        if i == STEPS - 1:
            grads, _, new_ef = specs.pod_gradients(
                cfg, params, {"tokens": tokens}, grid, True, ef, remat=False)
            for j, (g, e) in enumerate(zip(grads, tree_leaves(new_ef))):
                out[f"grad{j}"], out[f"ef{j}"] = g, e
        params, opt, m, ef = step(params, opt, {"tokens": tokens}, ef)
        out[f"loss{i}"] = m["loss"][None]
    for j, w in enumerate(tree_leaves(params)):
        out[f"weight{j}"] = w
    return out


def worker(rank, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=T, rank=rank)
    grid = LoopPods(2, "cpu").with_axes(data=LoopPods(1, "cpu"),
                                        model=DistPods(None, device="cpu"))
    got = run(grid)
    np.savez(f"{out_dir}/rank{rank}.npz",
             **{k: v.detach().numpy() for k, v in got.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
    out_dir = sys.argv[1]
    mp.spawn(worker, args=(port, out_dir), nprocs=T)
    want = {k: v.detach().numpy() for k, v in run(
        make_debug_mesh(2, model=T, device="cpu")).items()}
    split = 0
    for r in range(T):
        got = dict(np.load(f"{out_dir}/rank{r}.npz"))
        for k, w in want.items():
            g = got[k]
            if g.shape != w.shape:          # a split leaf: this rank's shard
                dim = 1 if k.startswith("ef") else 0
                w, split = np.take(w, [r], axis=dim), split + 1
            assert np.array_equal(g, w), (k, r, np.abs(g - w).max())
    assert split > 0
    print("equal", len(want), split)
'''


def test_torch_int8_leg_with_the_model_axis_across_processes(tmp_path):
    """DistPods(gloo, 2) as the model axis under LoopPods(2) pods: two
    int8-leg steps bit for bit LoopPods (2, model 2)'s (a spawned pair with
    its own 90 s limit)."""
    script = tmp_path / "int8_leg_worker.py"
    script.write_text(WORKER)
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, timeout=90, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("equal"), out.stdout


class _OtherRank:
    """The model axis as one rank of two sees it (``DistPods``' local 1):
    each ``pmax`` against the other rank's operand of that call (its
    shard's maximum, one a pod, in the order ``_one`` visits the pods)."""
    n, local = 2, 1

    def __init__(self, others):
        self.others = list(others)

    def pmax(self, x):
        return torch.maximum(x, self.others.pop(0))


def test_torch_int8_scale_of_a_split_leaf_is_the_whole_leafs():
    """Each shard of a split leaf quantized on its own process takes the
    whole leaf's scale (the pmax of the shards' maxima): its average and
    error buffer equal the whole leaf's chunk bit for bit; on its own
    maximum (no model axis) the shard without the leaf's maximum does
    not."""
    rng = np.random.default_rng(1)
    leaf = torch.from_numpy(rng.standard_normal((2, 2, 6, 5)).astype(np.float32))
    leaf[:, 1] *= 7.0                         # shard 1 holds the larger values
    pods = LoopPods(2, "cpu")
    whole_avg, whole_err = compression._one(leaf, None, pods)
    avg, err = compression._one(leaf, None, pods, LoopPods(2, "cpu"))
    assert torch.equal(avg, whole_avg) and torch.equal(err, whole_err)
    maxima = leaf.abs().flatten(2).amax(2)                      # [pods, shards]
    for r in range(2):
        mine = leaf[:, r:r + 1]
        axis = _OtherRank(maxima[p, 1 - r][None] for p in range(2))
        a, e = compression._one(mine, None, pods, axis)
        assert torch.equal(a, whole_avg[:, r:r + 1])
        assert torch.equal(e, whole_err[:, r:r + 1])
    _, own_err = compression._one(leaf[:, :1], None, pods)
    assert not torch.equal(own_err, whole_err[:, :1])


# ------------------------------------------------------------------ cells
CELL_SHAPES = {step: tconfigs.ShapeSpec(f"{step}_smoke", 24, 4, step)
               for step in ("prefill", "decode")}


def _joined(cfg, grp, name, t, layout):
    """A cache of one group with its model-shard lead [L, t, ...] joined
    back into the whole: kv heads, the SSD's heads of ``h``, the RG-LRU's
    channels, the SSD conv tail's channels section by section."""
    split = layout.state_split if name in ("h", "conv") else layout.kv_split
    if split == 1:
        return t
    shards = t.unbind(1)
    if name == "h":
        return torch.cat(shards, dim=-3 if grp.kind == "ssd" else -1)
    if name == "conv" and grp.kind == "ssd":
        widths = [w // split for w in (cfg.d_inner, cfg.ssm_state, cfg.ssm_state)]
        parts = [s.split(widths, dim=-1) for s in shards]
        return torch.cat([p[j] for j in range(3) for p in parts], dim=-1)
    return torch.cat(shards, dim=-1 if name == "conv" else -2)


def _row_kv(cfg, state, tables):
    """Each paged slab group's keys and values at every row's positions
    [L, B, positions, K, hd], read through the tables (pooled slabs through
    each row's pool), and every cache held a row, all joined whole."""
    lay = state.layout
    out = {}
    for g, (grp, cache) in enumerate(zip(tm.layer_groups(cfg), state.caches)):
        for name in ("k_slabs", "v_slabs"):
            if name not in cache:
                continue
            t = _joined(cfg, grp, name, cache[name], lay)
            glob = tables.long()
            if lay.pools > 1:
                F = t.shape[2]
                t = t.flatten(1, 2)
                pool = torch.arange(tables.shape[0]) // max(
                    tables.shape[0] // lay.pools, 1)
                glob = glob + pool[:, None] * F
            L, _, _, K, hd = t.shape
            rows = t[:, glob]                        # [L, B, MB, bt, K, hd]
            out[(g, name)] = rows.flatten(2, 3)[:, :, :24 + 1]
        for name in ROW_CACHES:
            if name in cache:
                out[(g, name)] = _joined(cfg, grp, name, cache[name], lay)
    return out


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_torch_cells_on_a_real_grid_equal_the_grid_of_one(arch, step):
    """The smoke cell on a (pods 2, data 2, model 2) CPU grid (four KV
    pools, pool-local tables, rows over the data axis, weights over the
    model axis) against the same cell on a grid of one: sampled tokens
    equal, every row's KV and every cache held a row within 1e-5; the model
    and pod axes' counters equal ``analysis.cell_wire_bytes``."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype=torch.float32)
    runs = {}
    for shape in ((1, 1, 1), (2, 2, 2)):
        grid = make_debug_mesh(shape[0], data=shape[1], model=shape[2],
                               device="cpu")
        cell = specs.build_cell(arch, CELL_SHAPES[step], grid, cfg=cfg,
                                device="cpu")
        grid.reset_counters()
        grid.model.reset_counters()
        with torch.no_grad():
            tok, state = cell.step_fn(*cell.args)
        wire = analysis.cell_wire_bytes(cell)
        assert grid.model.wire_bytes == wire["model"], (shape, wire)
        assert grid.wire_bytes == wire.get("pod", 0)
        runs[shape] = (tok, _row_kv(cfg, state, cell.args[-1]))
    (t1, c1), (t2, c2) = runs[(1, 1, 1)], runs[(2, 2, 2)]
    assert torch.equal(t1, t2)
    assert set(c1) == set(c2)
    for k in c1:
        assert float((c1[k].float() - c2[k].float()).abs().max()) <= OWN_TOL, k


def test_torch_int8_leg_cell_counts_its_scales():
    """Train cells on (pods 2, model 2) with and without the int8 pod leg:
    the leg adds one model-axis ``pmax`` of the shards' maxima a split leaf
    a pod, and ``analysis.model_wire`` (a line of the model axis) adds the
    same float32 a split leaf."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("yi_6b"),
                              dtype=torch.float32)
    shape = tconfigs.ShapeSpec("train_smoke", 24, 4, "train")
    wire, counted = {}, {}
    for leg in (False, True):
        grid = make_debug_mesh(2, model=2, device="cpu")
        cell = specs.build_cell("yi_6b", shape, grid, cfg=cfg, device="cpu",
                                opts=specs.PerfOptions(compress_pod_grads=leg))
        grid.model.reset_counters()
        cell.step_fn(*cell.args)
        wire[leg], counted[leg] = analysis.model_wire(cell), grid.model.wire_bytes
    n_split, t = sum(specs.split_leaves(cell.args[0])), 2
    assert n_split > 0
    assert wire[True] - wire[False] == t * (t - 1) * 4 * n_split
    assert counted[True] - counted[False] == 2 * (wire[True] - wire[False])


@pytest.mark.parametrize("t", [1, 2])
def test_torch_adamw_in_chunks_is_bit_identical(monkeypatch, t):
    """AdamW updates a leaf larger than ``CHUNK`` a chunk at a time (how an
    MoE layer's experts and their moments train on one card): parameters
    and moments bit for bit those of the whole-leaf update, split leaves
    at model 2 included."""
    from repro_torch._tree import tree_leaves
    from repro_torch.optim import adamw
    cfg = tconfigs.get_smoke_config("qwen3_moe_235b_a22b")
    grid = make_debug_mesh(1, model=t, device="cpu")
    runs = []
    for chunk in (adamw.CHUNK, 333):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        params = specs.shard_params(tm.init_params(
            cfg, torch.Generator().manual_seed(0)), grid, cfg)
        grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
                 for i, p in enumerate(tree_leaves(params))]
        state = adamw.adamw_init(params)
        for _ in range(2):
            params, state, _ = adamw.adamw_update(
                params, grads, state, tp=grid.model if t > 1 else None,
                split=specs.split_leaves(params) if t > 1 else None)
        runs.append(tree_leaves(params) + tree_leaves(state.mu)
                    + tree_leaves(state.nu))
    assert any(p.numel() > 333 for p in runs[0])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
