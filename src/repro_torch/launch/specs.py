"""Sharding rules on the grid, and the step builders: train and serve
steps over the grid's pod, data and model axes, with the numaPTE
block-table coherence prologue and the int8 pod gradient leg.

The grid (``launch/mesh.py``) is a pod axis carrying ``.data`` and
``.model``, each a ``repro_torch.distributed.Pods``: ``LoopPods`` on one
device, ``DistPods`` over ``torch.distributed``.  ``make_rules`` /
``_divisible`` / ``param_shardings`` are the reference's (a spec is a tuple
in place of a ``PartitionSpec``), with two layout differences of explicit
tensor parallelism: attention splits by whole heads (``_whole_heads``),
where GSPMD may split ``wq``/``wk``/``wv`` by columns through a head; and
the SSD's fused leaves split by section (``_ssd_split``: shard i takes
chunk i of each of ``in_proj``'s ``[z | x | B | C | dt]`` and of the conv's
``[x | B | C]``), where GSPMD splits their columns contiguously, across the
sections.  ``shard_params`` splits each sharded leaf over the model axis
into a leading local-shard dimension ``[p, ...]``, as the pod axis does;
``gather_params`` is its inverse.  Pool-partitioned KV, sequence-parallel
decode and the int8 pod leg of a model axis split across processes raise
NotImplementedError naming ROADMAP queue 1 slice 16.1c
(``require_model_axis``).

The reference also builds ShapeDtypeStruct cells for an XLA dry run on a
512-device mesh (``build_cell``, ``_state_shardings``, ``PerfOptions``, the
decode geometry that feeds them); those wait for ROADMAP queue 1 slice 16.2.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import torch

from .._tree import tree_leaves, tree_leaves_with_path, tree_map, \
    tree_map_with_path
from ..distributed.compression import compress_allreduce_pods
from ..distributed.pods import Pods
from ..distributed.sharding import (MULTI_POD_RULES, SINGLE_POD_RULES,
                                    ShardingRules, Spec, param_pspec,
                                    use_rules)
from ..models import greedy_sample, lm_loss
from ..models.common import ModelConfig
from ..models.transformer import DecodeState, decode_step, prefill, vocab_split
from ..optim import adamw_update
from ..pagedpt.coherence import eager_sync, numapte_prologue

PyTree = Any


# --------------------------------------------------------------------------- rules
def _axis_sizes(grid: Pods) -> Dict[str, int]:
    return {"pod": grid.n, "data": grid.data.n, "model": grid.model.n}


def make_rules(cfg: ModelConfig, grid: Pods) -> ShardingRules:
    """The base table of the grid (multi-pod when its pod axis splits), the
    config's ``rule_overrides`` on top.  (The reference's Megatron-SP
    option, ``act_seq`` on ``model``, waits with ``PerfOptions`` for slice
    16.2.)"""
    base = MULTI_POD_RULES if grid.n > 1 else SINGLE_POD_RULES
    table = dict(base.rules)
    table.update(dict(cfg.rule_overrides))
    return ShardingRules(rules=tuple(table.items()))


def _divisible(shape: Tuple[int, ...], spec: Spec, grid: Pods) -> Spec:
    """Drop sharding on dims the axis size doesn't divide (explicit
    replication, as the reference prefers to GSPMD's padding)."""
    sizes = _axis_sizes(grid)
    fixed = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            fixed.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        size = math.prod(sizes[a] for a in axes)
        fixed.append(axis if dim % size == 0 else None)
    return tuple(fixed)


class Shard(NamedTuple):
    """A leaf's split: the dimension of the unsharded leaf, over ``axis``;
    ``sections``: the widths of the sections along it that split one by one
    (shard i holds chunk i of each, in order), or () for one contiguous
    split."""
    dim: int
    axis: str
    sections: Tuple[int, ...] = ()


def _whole_heads(name: str, spec: Spec, cfg: ModelConfig, t: int) -> Spec:
    """Explicit tensor parallelism splits attention by whole heads: the
    query heads (``wq``'s columns, ``wo``'s rows) when t divides H, and the
    kv heads (``wk``/``wv``'s columns) only when t also divides K; otherwise
    the kv projection stays replicated, and then each shard's query heads
    must share one kv head (else the attention stays replicated whole).
    GSPMD splits the columns wherever t divides them, cutting through a head
    if need be; the arithmetic is the same."""
    if name not in ("wq", "wk", "wv", "wo") or all(a is None for a in spec):
        return spec
    H, K = cfg.n_heads, cfg.n_kv_heads
    heads_ok = H % t == 0 and (K % t == 0 or cfg.q_per_kv % (H // t) == 0)
    if not heads_ok or (name in ("wk", "wv") and K % t):
        return (None,) * len(spec)
    return spec


#: the SSD's leaves split over the model axis (the reference's ``ff``), and
#: the fused ones among them, by their sections
SSD_SPLIT = ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
             "out_proj")
SSD_FUSED = ("in_proj", "conv_w", "conv_b")


def _ssd_sections(name: str, d_inner: int, n: int, H: int) -> Tuple[int, ...]:
    """The section widths of a fused SSD leaf along its split dimension:
    ``in_proj``'s columns ``[z | x | B | C | dt]``, the conv's channels
    ``[x | B | C]``."""
    return ((d_inner, d_inner, n, n, H) if name == "in_proj"
            else (d_inner, n, n))


def _ssd_split(name: str, spec: Spec, cfg: ModelConfig, t: int
               ) -> Optional[Shard]:
    """The split of an SSD layer's ``SSD_SPLIT`` leaf: a layer splits whole
    or not at all, each leaf over the model axis when the rules put ``ff``
    there and t divides its heads H and its state width n (every section
    then splits evenly), the fused ones section by section.  GSPMD splits
    each leaf that t divides on its own, and ``in_proj``'s 2 d_inner + 2 n
    + H columns across its sections; the arithmetic is the same."""
    shard = _shard_of(spec)
    if shard is None or cfg.ssm_n_heads % t or cfg.ssm_state % t:
        return None
    if name not in SSD_FUSED:
        return shard
    return shard._replace(sections=_ssd_sections(
        name, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads))


def _shard_of(spec: Spec) -> Optional[Shard]:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if axes != ("model",):
            raise NotImplementedError(f"a parameter split over {axes}: only "
                                      "the model axis splits parameters")
        return Shard(dim, "model")
    return None


def require_model_axis(grid: Optional[Pods], *, pooled: bool = False,
                       sp: bool = False, int8_leg: bool = False) -> None:
    """NotImplementedError naming ROADMAP queue 1 slice 16.1c for what the
    model axis does not run yet: pool-partitioned KV (``pooled``),
    sequence-parallel decode (``sp``), and the int8 pod leg with the model
    axis split across processes (``int8_leg``).  Every family runs over
    the model axis otherwise."""
    if grid is None or grid.model.n == 1:
        return
    model = grid.model
    what = ("pool-partitioned KV" if pooled else
            "sequence-parallel decode" if sp else
            "the int8 pod leg with the model axis split across processes"
            if int8_leg and model.local != model.n else None)
    if what is not None:
        raise NotImplementedError(
            f"{what} over the model axis waits for ROADMAP queue 1 slice 16.1c")


def param_shardings(params: PyTree, grid: Pods, cfg: ModelConfig,
                    rules: Optional[ShardingRules] = None) -> PyTree:
    """Each leaf of a parameter tree (the port's unstacked tree, or any tree
    whose leaves are named like it: AdamW's moments) -> its ``Shard`` (the
    split dimension and axis) or None (replicated): ``param_pspec`` under
    ``rules`` (default ``make_rules(cfg, grid)``), ``_divisible`` on the
    grid, then ``_whole_heads``; an SSD layer's leaves instead by
    ``_ssd_split`` (before ``_divisible``: its rule looks at the sections,
    not at ``in_proj``'s whole width), its fused ones carrying their
    sections.  Leaves need only ``.shape``."""
    rules = rules or make_rules(cfg, grid)
    t = grid.model.n

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = param_pspec(path, shape)
        if len(path) > 1 and path[-2] == "ssd" and path[-1] in SSD_SPLIT:
            return _ssd_split(path[-1], spec, cfg, t)
        spec = _divisible(shape, spec, grid)
        return _shard_of(_whole_heads(path[-1], spec, cfg, t))

    with use_rules(rules):
        return tree_map_with_path(one, params)


def kv_split(cfg: ModelConfig, grid: Pods,
             rules: Optional[ShardingRules] = None) -> int:
    """How many model shards split the paged KV slabs' kv heads: t when the
    rules map ``kv_heads`` to the model axis and the heads split whole over
    it (t divides K), else 1 (the slabs replicated over the model axis,
    which every config's own rules ask for)."""
    rules = rules or make_rules(cfg, grid)
    t = grid.model.n
    on_model = lambda ax: (ax if isinstance(ax, tuple) else (ax,)) == ("model",)
    if t == 1 or not (on_model(rules.lookup("kv_heads"))
                      and on_model(rules.lookup("heads"))):
        return 1
    wk = _whole_heads("wk", (None, "model"), cfg, t)
    return t if wk[1] is not None else 1


def state_split(params: PyTree, grid: Pods) -> int:
    """How many model shards split the recurrent layers' decode states (the
    SSD's and the RG-LRU's ``h`` and conv tail): the model axis's size when
    ``params`` split those layers' channels over it, else 1."""
    for path, leaf in tree_leaves_with_path(params):
        if path[-1] in ("in_proj", "rg_in") and _split_dim(path, leaf) is not None:
            return grid.model.n
    return 1


#: every logical axis on 'model': the name table's split dimension of a leaf
_ALL_MODEL = ShardingRules(rules=tuple(
    (n, "model") for n in ("heads", "ff", "vocab", "experts")))


def _split_dim(path: Tuple[str, ...], leaf) -> Optional[int]:
    """The dimension of the unsharded leaf along which ``leaf`` (with or
    without the leading local-shard dimension) was split, or None when it
    is whole: a leaf is split when its rank is its name's unsharded rank
    plus one."""
    with use_rules(_ALL_MODEL):
        spec = param_pspec(path, ())
    if not spec or leaf.dim() != len(spec) + 1:
        return None
    return spec.index("model")


def split_leaves(tree: PyTree) -> List[bool]:
    """For each leaf of ``tree``, in order: whether it is split over the
    model axis (carries the local-shard dimension)."""
    return [_split_dim(path, leaf) is not None
            for path, leaf in tree_leaves_with_path(tree)]


def shard_params(params: PyTree, grid: Pods, cfg: ModelConfig,
                 rules: Optional[ShardingRules] = None) -> PyTree:
    """Split each sharded leaf of ``params`` (whole leaves, any tree named
    like the parameters) over the grid's model axis: [p, ...] with the
    local shards' slices, new contiguous tensors.  Replicated leaves are the
    same tensors.  A model axis of size 1 returns ``params`` itself."""
    model = grid.model
    if model.n == 1:
        return params
    shards = param_shardings(params, grid, cfg, rules)
    return tree_map(lambda leaf, shard: shard_leaf(leaf, shard, model),
                    params, shards)


def shard_leaf(leaf: torch.Tensor, shard: Optional[Shard], model: Pods
               ) -> torch.Tensor:
    """One leaf of ``shard_params``: its local shards' slices stacked
    [p, ...] (new contiguous tensors), or the leaf itself when ``shard`` is
    None."""
    if shard is None:
        return leaf
    parts = (leaf.detach().split(list(shard.sections), dim=shard.dim)
             if shard.sections else (leaf.detach(),))
    chunks = [part.chunk(model.n, dim=shard.dim) for part in parts]
    return torch.stack([torch.cat([c[i] for c in chunks], dim=shard.dim)
                        for i in model.local_indices()]).contiguous()


def _sections_in(tree: PyTree, t: int) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """The sections of every split fused SSD leaf of ``tree`` (by path),
    from its layer's leaves: d_inner from the replicated ``norm_scale``, H
    and n from the split ``a_log`` and ``conv_b``."""
    leaves = dict(tree_leaves_with_path(tree))
    out = {}
    for path, leaf in leaves.items():
        if path[-1] != "in_proj" or _split_dim(path, leaf) is None:
            continue
        layer = path[:-1]
        d_inner = leaves[layer + ("norm_scale",)].shape[-1]
        H = t * leaves[layer + ("a_log",)].shape[-1]
        n = (t * leaves[layer + ("conv_b",)].shape[-1] - d_inner) // 2
        for name in SSD_FUSED:
            out[layer + (name,)] = _ssd_sections(name, d_inner, n, H)
    return out


def gather_params(tree: PyTree, grid: Pods) -> PyTree:
    """``shard_params``' inverse: every split leaf gathered over the model
    axis into the whole leaf (detached; a fused SSD leaf section by
    section); other leaves as they are."""
    model = grid.model
    sections = _sections_in(tree, model.n)

    def one(path, leaf):
        dim = _split_dim(path, leaf)
        if dim is None:
            return leaf
        whole = model.all_gather(leaf.detach())[0]       # [n, ...]
        if path not in sections:
            return torch.cat(list(whole.unbind(0)), dim=dim)
        widths = [w // model.n for w in sections[path]]
        pieces = [s.split(widths, dim=dim) for s in whole.unbind(0)]
        return torch.cat([p[j] for j in range(len(widths)) for p in pieces],
                         dim=dim)

    return tree_map_with_path(one, tree)

#: the prefetch degree of the reference's cells (their per-step budgets,
#: 1 024 mutations and 256 misses a pod, are ``BlockTableSpec``'s defaults)
PREFETCH_DEGREE = 3


# --------------------------------------------------------------------------- steps
def _grads(cfg: ModelConfig, params: PyTree, batch: Dict[str, torch.Tensor],
           tp: Optional[Pods] = None):
    """(total, metrics, gradients of params' leaves); ``tp``: the model
    axis (a split leaf's gradient is its local shards' [p, ...])."""
    cparams = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = lm_loss(cfg, cparams, batch, tp)
    grads = torch.autograd.grad(total, tree_leaves(cparams))
    return total.detach(), metrics, list(grads)


def _split_rows(batch: Dict[str, torch.Tensor], p: int
                ) -> List[Dict[str, torch.Tensor]]:
    return [{k: v.view(p, v.shape[0] // p, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(p)]


def _averaged(axis: Pods, stacked: List[torch.Tensor],
              metrics: List[Dict[str, torch.Tensor]]):
    """Gradients [p, ...] a leaf and each local share's metrics -> the
    mean over ``axis`` (psum / n, in each leaf's dtype), and the metrics:
    ``loss`` and ``aux`` the mean, ``tokens`` the sum."""
    n = axis.n
    grads = [axis.psum(g)[0] / n for g in stacked]
    out = {k: axis.psum(torch.stack([m[k] for m in metrics]))[0]
           for k in metrics[0]}
    out["loss"] = out["loss"] / n
    out["aux"] = out["aux"] / n
    return grads, out


def data_gradients(cfg: ModelConfig, params: PyTree,
                   batch: Dict[str, torch.Tensor], grid: Pods):
    """The in-pod half of a train step: each local data shard differentiates
    its share of ``batch`` (the rows split evenly) through the model axis,
    and the shares' gradients are averaged over the data axis (float32 for
    float32 leaves), as ``pod_gradients`` averages the pods'.  Returns
    (gradients, metrics); with a data axis of size 1, ``_grads``' own."""
    data, tp = grid.data, grid.model
    if data.n == 1:
        _, m, g = _grads(cfg, params, batch, tp)
        return g, {k: v.detach() for k, v in m.items()}
    p = data.local
    stacked, share_metrics = None, []
    for i, share in enumerate(_split_rows(batch, p)):
        _, m, g = _grads(cfg, params, share, tp)
        if stacked is None:
            stacked = [torch.empty((p,) + t.shape, dtype=t.dtype,
                                   device=t.device) for t in g]
        for buf, t in zip(stacked, g):
            buf[i].copy_(t)
        del g
        share_metrics.append({k: v.detach() for k, v in m.items()})
    return _averaged(data, stacked, share_metrics)


def pod_gradients(cfg: ModelConfig, params: PyTree,
                  batch: Dict[str, torch.Tensor], pods: Pods,
                  compress_pod_grads: bool = False, ef: Optional[List] = None):
    """The pod axis's half of a train step: each local pod differentiates
    its share of the batch (the rows split evenly over the local pods), and
    the pod leg averages the gradients over the axis — in float32, or with
    ``compress_pod_grads`` in int8 with error feedback (``ef``: the per-pod
    residuals [p, ...] of the previous step, None at the first).  A pod's
    share goes through the grid's in-pod axes (``data_gradients``) when
    ``pods`` carries them.  Returns (the averaged gradient of each leaf, as
    the step hands it to AdamW; metrics: ``loss`` and ``aux`` the pods'
    mean, ``tokens`` their sum; the new error buffers, ``ef`` itself for the
    float32 leg)."""
    p, n = pods.local, pods.n
    require_model_axis(pods, int8_leg=compress_pod_grads)
    stacked, pod_metrics = None, []
    for i, share in enumerate(_split_rows(batch, p)):
        g, m = data_gradients(cfg, params, share, pods)
        if stacked is None:      # [p, ...] a leaf, filled pod by pod
            stacked = [torch.empty((p,) + t.shape, dtype=t.dtype,
                                   device=t.device) for t in g]
        for buf, t in zip(stacked, g):
            buf[i].copy_(t)
        del g
        pod_metrics.append(m)
    new_ef = ef
    if compress_pod_grads:
        avg, new_ef = compress_allreduce_pods(stacked, ef, pods)
        grads = [a[0] for a in avg]
        metrics = _averaged(pods, [], pod_metrics)[1]
    else:
        grads, metrics = _averaged(pods, stacked, pod_metrics)
    del stacked
    return grads, metrics, new_ef


def build_train_step(cfg: ModelConfig, compress_pod_grads: bool = False,
                     pods: Optional[Pods] = None) -> Callable:
    """``step(params, opt_state, batch, ef=None)``: gradients, then one
    ``adamw_update`` (in place).  Without ``pods`` the gradients are
    ``lm_loss``'s; with ``pods`` (the grid: its pod axis, carrying
    ``.data`` and ``.model``) they are ``pod_gradients``' average, and
    ``params`` / ``opt_state`` are split over the model axis
    (``shard_params``): the clip's norm sums the split leaves over it, and
    decay is decided on each leaf's unsharded rank.  Returns (params,
    opt_state, metrics), and the new error buffers as a fourth item when the
    leg is compressed or ``ef`` is given."""
    require_model_axis(pods, int8_leg=compress_pod_grads)

    def train_step(params, opt_state, batch, ef=None):
        tp, split = None, None
        if pods is None:
            _, metrics, grads = _grads(cfg, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
            new_ef = ef
        else:
            grads, metrics, new_ef = pod_gradients(
                cfg, params, batch, pods, compress_pod_grads, ef)
            if pods.model.n > 1:
                tp, split = pods.model, split_leaves(params)
        params, new_opt, gnorm = adamw_update(params, grads, opt_state,
                                              tp=tp, split=split)
        metrics = dict(metrics, grad_norm=gnorm)
        if compress_pod_grads or ef is not None:
            return params, new_opt, metrics, new_ef
        return params, new_opt, metrics
    return train_step


@contextlib.contextmanager
def timed(into: List, device: torch.device):
    """Append a (start, end) pair around the block: CUDA events on the
    card (read them with ``elapsed_ms`` once the device is synchronised),
    host clock readings on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        yield
        end.record()
    else:
        start = time.perf_counter()
        yield
        end = time.perf_counter()
    into.append((start, end))


def elapsed_ms(pair) -> float:
    start, end = pair
    if isinstance(start, float):
        return 1e3 * (end - start)
    return start.elapsed_time(end)


def _row_shares(data: Pods, B: int, state: DecodeState) -> List[slice]:
    """The rows of a batch of B that each local data shard serves.  The
    paged slabs are shared (each row's frames its own); a cache held a row
    (a ring, a recurrent state, cross K/V) is not split over the data axis
    yet (ROADMAP queue 1 slice 16.1c)."""
    if any(name in cache for cache in state.caches
           for name in ("ring_k", "h", "cross_k")):
        raise NotImplementedError("per-row caches over the data axis wait "
                                  "for ROADMAP queue 1 slice 16.1c")
    if B % data.local:
        raise ValueError(f"{B} rows do not split over {data.local} data shards")
    n = B // data.local
    return [slice(i * n, (i + 1) * n) for i in range(data.local)]


def decode_on_grid(cfg: ModelConfig, params: PyTree, state: DecodeState,
                   tokens: torch.Tensor, phys_blocks: torch.Tensor,
                   grid: Optional[Pods], *, sp: bool = False
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """``decode_step`` over the grid: the rows split over the data axis (a
    call a local data shard; the paged slabs are shared, each row's frames
    its own), the model axis as ``tp``, sequence parallelism over the pod
    axis with ``sp``.  Logits come as ``decode_step`` gives them (vocab
    shards over a split model axis), rows in order."""
    tp = None if grid is None else grid.model
    data = None if grid is None else grid.data
    if data is None or data.local == 1:
        return decode_step(cfg, params, state, tokens, phys_blocks, sp=sp,
                           pods=grid, tp=tp)
    logits, lens = [], []
    for rows in _row_shares(data, tokens.shape[0], state):
        lg, st = decode_step(cfg, params,
                             DecodeState(state.caches, state.seq_lens[rows]),
                             tokens[rows], phys_blocks[rows], sp=sp,
                             pods=grid, tp=tp)
        logits.append(lg)
        lens.append(st.seq_lens)
    return torch.cat(logits, dim=-2), DecodeState(state.caches, torch.cat(lens))


def prefill_on_grid(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
                    state: DecodeState, phys_blocks: torch.Tensor,
                    grid: Optional[Pods]) -> Tuple[torch.Tensor, DecodeState]:
    """``prefill`` over the grid, split as ``decode_on_grid`` splits."""
    tp = None if grid is None else grid.model
    data = None if grid is None else grid.data
    if data is None or data.local == 1:
        return prefill(cfg, params, tokens, state, phys_blocks, tp=tp)
    logits, lens = [], []
    for rows in _row_shares(data, tokens.shape[0], state):
        lg, st = prefill(cfg, params, tokens[rows], state, phys_blocks[rows],
                         tp=tp)
        logits.append(lg)
        lens.append(st.seq_lens)
    return torch.cat(logits, dim=-2), DecodeState(state.caches, torch.cat(lens))


def grid_sampler(params: PyTree, grid: Optional[Pods]) -> Callable:
    """Greedy sampling of the logits ``decode_on_grid`` gives: over the
    vocab shards when the head is split over the model axis."""
    tp = None if grid is None or grid.model.n == 1 else grid.model
    if tp is not None and vocab_split(params):
        return lambda logits: greedy_sample(logits, tp)
    return greedy_sample


def build_serve_step(cfg: ModelConfig, sp: bool = False,
                     coherence: str = "none", pods: Optional[Pods] = None,
                     sample: Optional[Callable] = None,
                     prologue_timer: Optional[List] = None) -> Callable:
    """``step(params, state, tokens, phys_blocks, *coh_args)``: the
    block-table coherence prologue over ``pods`` (when ``coherence`` is
    ``eager`` or ``numapte`` and ``coh_args`` are given: the replicas [p, T,
    epb] and the buffers of ``_coherence_prologue``), then one decode step
    over the grid (``decode_on_grid``: ``pods`` is the grid's pod axis,
    carrying its data and model axes; sequence-parallel over the pods with
    ``sp``), then ``sample`` of its logits (default greedy, over the vocab
    shards when the model axis splits the head).  Returns (sampled tokens,
    state) and, after a prologue, its (replicas, sharers) as a third item.
    ``prologue_timer``: a list that gets a ``timed`` pair around each
    prologue."""
    if coherence not in ("none", "eager", "numapte"):
        raise ValueError(f"coherence {coherence!r}")
    require_model_axis(pods, sp=sp)

    def step(params, state, tokens, phys_blocks, *coh_args):
        coh_out = None
        if coherence != "none" and coh_args:
            timer = (contextlib.nullcontext() if prologue_timer is None
                     else timed(prologue_timer, coh_args[0].device))
            with timer:
                coh_out = _coherence_prologue(coherence, pods, *coh_args)
        logits, state = decode_on_grid(cfg, params, state, tokens,
                                       phys_blocks, pods, sp=sp)
        sampled = (sample or grid_sampler(params, pods))(logits)
        if coh_out is None:
            return sampled, state
        return sampled, state, coh_out
    return step


def _coherence_prologue(mode: str, pods: Pods, entries, sharers, owner,
                        mut_t, mut_i, mut_v, mut_ok, miss
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step block-table coherence over the pod axis — the paper's
    mechanism in the step.  EAGER gathers every pod's mutation buffer every
    step and applies all of it (Mitosis: one K3 launch); NUMAPTE applies
    only sharer-filtered updates and fetches misses from owners with
    degree-d prefetch (two K3 launches).  entries [p, T, epb] are updated in
    place; returns (entries, sharers)."""
    if mode == "eager":
        return eager_sync(entries, mut_t, mut_i, mut_v, mut_ok, pods), sharers
    return numapte_prologue(entries, sharers, owner, mut_t, mut_i, mut_v,
                            mut_ok, miss, PREFETCH_DEGREE, pods)
