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
``gather_params`` is its inverse.  Every option of the reference's grid
runs over the model axis: pool-partitioned KV (each shard's kv heads of
the pools, or its own split pools), sequence-parallel decode (each shard's
heads over the pods, ``decode_attention_sp``), and the int8 pod leg, whose
scale of a leaf split over the model axis is the ``pmax`` of the shards'
maxima, the whole leaf's, on ``LoopPods`` and across processes alike.
Over the data axis each local shard serves its rows through a decode state
of views (``_data_share``): the caches held a row (rings, recurrent states,
cross K/V) are its rows' views, pooled slabs the pools its rows live in.

The dry run's cells (``build_cell``): each (arch x shape) of
``configs.all_cells`` on the production grid, ``make_debug_mesh(pods,
data=16, model=16, device="meta")``, its arguments the port's real trees on
the ``meta`` device (nothing drawn or allocated), each leaf with the number
of devices it is split over (``CellSpec.shares``, in place of the
reference's NamedShardings: ``param_shardings`` for the parameters and
moments, ``kv_split`` / ``state_split`` and the rows of ``_row_shares`` for
the decode state); ``launch/analysis.py`` reads them.  With
``device="cuda"`` the same function builds a cell the card runs.
``PerfOptions`` are the reference's levers.  Megatron sequence parallelism
(``seq_parallel``) is, as in the reference, a rule: ``make_rules`` puts
``act_seq`` on ``model``, a cell's step runs under its rules, and the
models then split the residual stream over the model axis between blocks
in the train and prefill steps (``models/transformer.py``), each stack
where t divides its length; a decode step (one row) never splits, and
``CellSpec.seq_split`` records which stacks ran split.
``decode_kernel="fused_ref"`` (the reference's model of its Pallas
kernel's streaming) raises a ValueError: the port decodes with K1.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

import torch

from .. import tracing
from . import step_graph
from .._tree import tree_leaves, tree_leaves_with_path, tree_map, \
    tree_map_with_path
from ..distributed.compression import compress_allreduce_pods
from ..distributed.pods import Pods
from ..distributed.sharding import (MULTI_POD_RULES, SINGLE_POD_RULES,
                                    ShardingRules, Spec, param_pspec,
                                    use_rules)
from .._device import DeviceLike, resolve_device
from ..configs import ShapeSpec, get_config
from ..models import greedy_sample, init_decode_state, init_params, lm_loss
from ..kvcache.gather import pool_of_rows
from ..models.common import SHAPES_ONLY, ModelConfig
from ..models.transformer import (DecodeState, decode_step, prefill,
                                  prefill_encdec, remat_policy, seq_splits,
                                  vocab_split)
from ..optim import adamw_init, adamw_update
from ..optim.adamw import decays
from ..kernels.pte_gather.ops import pte_gather
from ..pagedpt.blocktable import ENTRIES_PER_TABLE, BlockTableSpec
from ..pagedpt.coherence import eager_sync, numapte_prologue
from .mesh import make_debug_mesh

PyTree = Any


# --------------------------------------------------------------------------- rules
def _axis_sizes(grid: Pods) -> Dict[str, int]:
    return {"pod": grid.n, "data": grid.data.n, "model": grid.model.n}


def make_rules(cfg: ModelConfig, grid: Pods,
               opts: Optional["PerfOptions"] = None) -> ShardingRules:
    """The base table of the grid (multi-pod when its pod axis splits), the
    config's ``rule_overrides`` on top, and, with ``opts.seq_parallel``,
    ``act_seq`` on ``model``: Megatron sequence parallelism, which the
    models read from the rules in force (``transformer.seq_shards``; where
    a stack splits, ``seq_split`` says, as ``_divisible`` would)."""
    base = MULTI_POD_RULES if grid.n > 1 else SINGLE_POD_RULES
    table = dict(base.rules)
    table.update(dict(cfg.rule_overrides))
    if opts is not None and opts.seq_parallel:
        table["act_seq"] = "model"
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

#: the prefetch degree of the reference's cells: ``BlockTableSpec``'s
#: default, which the manager takes
PREFETCH_DEGREE = BlockTableSpec.prefetch_degree


# --------------------------------------------------------------------------- steps
def _compute_copy(path, p: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The leaf that a step differentiates: ``p`` detached, or with
    ``bf16`` a bfloat16 copy of a float32 leaf of the reference's rank 2 or
    more (its stacked tree's ``p.ndim >= 2``, ``optim/adamw.py:decays``, on
    the unsharded leaf)."""
    p = p.detach()
    split = _split_dim(path, p) is not None
    if bf16 and p.dtype == torch.float32 and decays(path, p, split):
        p = p.to(torch.bfloat16)
    return p.requires_grad_(True)


def _grads(cfg: ModelConfig, params: PyTree, batch: Dict[str, torch.Tensor],
           tp: Optional[Pods] = None, *, remat="full",
           bf16_grads: bool = False):
    """(total, metrics, gradients of params' leaves); ``tp``: the model
    axis (a split leaf's gradient is its local shards' [p, ...]);
    ``remat``: ``lm_loss``'s.  With ``bf16_grads`` the loss is
    differentiated with respect to a bfloat16 copy of every float32 matrix
    (``_compute_copy``) and each gradient is cast back to its parameter's
    dtype, as the reference's mixed precision does (its data axis's
    all-reduce then moves bf16; AdamW's float32 moments keep the
    precision)."""
    cparams = tree_map_with_path(
        lambda path, p: _compute_copy(path, p, bf16_grads), params)
    total, metrics = lm_loss(cfg, cparams, batch, tp, remat=remat)
    grads = torch.autograd.grad(total, tree_leaves(cparams))
    grads = [g.to(p.dtype) for g, p in zip(grads, tree_leaves(params))]
    return total.detach(), metrics, grads


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
                   batch: Dict[str, torch.Tensor], grid: Pods, *,
                   remat="full", bf16_grads: bool = False):
    """The in-pod half of a train step: each local data shard differentiates
    its share of ``batch`` (the rows split evenly) through the model axis,
    and the shares' gradients are averaged over the data axis (float32 for
    float32 leaves), as ``pod_gradients`` averages the pods'.  Returns
    (gradients, metrics); with a data axis of size 1, ``_grads``' own.
    ``remat`` / ``bf16_grads``: as ``_grads``'."""
    data, tp = grid.data, grid.model
    how = dict(remat=remat, bf16_grads=bf16_grads)
    if data.n == 1:
        _, m, g = _grads(cfg, params, batch, tp, **how)
        return g, {k: v.detach() for k, v in m.items()}
    p = data.local
    stacked, share_metrics = None, []
    for i, share in enumerate(_split_rows(batch, p)):
        _, m, g = _grads(cfg, params, share, tp, **how)
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
                  compress_pod_grads: bool = False, ef: Optional[List] = None,
                  *, remat="full", bf16_grads: bool = False):
    """The pod axis's half of a train step: each local pod differentiates
    its share of the batch (the rows split evenly over the local pods), and
    the pod leg averages the gradients over the axis — in float32, or with
    ``compress_pod_grads`` in int8 with error feedback (``ef``: the per-pod
    residuals [p, ...] of the previous step, None at the first).  A pod's
    share goes through the grid's in-pod axes (``data_gradients``) when
    ``pods`` carries them.  Returns (the averaged gradient of each leaf, as
    the step hands it to AdamW; metrics: ``loss`` and ``aux`` the pods'
    mean, ``tokens`` their sum; the new error buffers, ``ef`` itself for the
    float32 leg).  Over a split model axis the int8 leg takes each split
    leaf's scale over the whole leaf (``compress_allreduce_pods``' ``model``
    and ``split``).  ``remat`` / ``bf16_grads``: as ``_grads``'."""
    p, n = pods.local, pods.n
    if n == 1 and not compress_pod_grads:     # one pod's average: its own
        g, m = data_gradients(cfg, params, batch, pods, remat=remat,
                              bf16_grads=bf16_grads)
        return g, m, ef
    stacked, pod_metrics = None, []
    for i, share in enumerate(_split_rows(batch, p)):
        g, m = data_gradients(cfg, params, share, pods, remat=remat,
                              bf16_grads=bf16_grads)
        if stacked is None:      # [p, ...] a leaf, filled pod by pod
            stacked = [torch.empty((p,) + t.shape, dtype=t.dtype,
                                   device=t.device) for t in g]
        for buf, t in zip(stacked, g):
            buf[i].copy_(t)
        del g
        pod_metrics.append(m)
    new_ef = ef
    if compress_pod_grads:
        avg, new_ef = compress_allreduce_pods(stacked, ef, pods,
                                              model=pods.model,
                                              split=split_leaves(params))
        grads = [a[0] for a in avg]
        metrics = _averaged(pods, [], pod_metrics)[1]
    else:
        grads, metrics = _averaged(pods, stacked, pod_metrics)
    del stacked
    return grads, metrics, new_ef


def build_train_step(cfg: ModelConfig, compress_pod_grads: bool = False,
                     pods: Optional[Pods] = None, *, remat="full",
                     bf16_grads: bool = False) -> Callable:
    """``step(params, opt_state, batch, ef=None)``: gradients, then one
    ``adamw_update`` (in place).  ``remat`` (default ``"full"``: every
    layer rematerialised) and ``bf16_grads`` (differentiate a bfloat16 copy
    of the float32 matrices) are the reference's options (``_grads``);
    sequence parallelism comes from the rules in force (``make_rules``).  Without ``pods`` the gradients are
    ``lm_loss``'s; with ``pods`` (the grid: its pod axis, carrying
    ``.data`` and ``.model``) they are ``pod_gradients``' average, and
    ``params`` / ``opt_state`` are split over the model axis
    (``shard_params``): the clip's norm sums the split leaves over it, and
    decay is decided on each leaf's unsharded rank.  Returns (params,
    opt_state, metrics), and the new error buffers as a fourth item when the
    leg is compressed or ``ef`` is given."""
    remat_policy(remat)
    how = dict(remat=remat, bf16_grads=bf16_grads)

    def train_step(params, opt_state, batch, ef=None):
        tp, split = None, None
        if pods is None:
            _, metrics, grads = _grads(cfg, params, batch, **how)
            metrics = {k: v.detach() for k, v in metrics.items()}
            new_ef = ef
        else:
            grads, metrics, new_ef = pod_gradients(
                cfg, params, batch, pods, compress_pod_grads, ef, **how)
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


def _row_shares(data: Pods, B: int) -> List[slice]:
    """The rows of a batch of B that each local data shard serves."""
    if B % data.local:
        raise ValueError(f"{B} rows do not split over {data.local} data shards")
    n = B // data.local
    return [slice(i * n, (i + 1) * n) for i in range(data.local)]


def _pool_share(pools: int, B: int, rows: slice) -> Optional[slice]:
    """The pools that ``rows`` of a batch of B live in (row b in pool ``b //
    max(B // pools, 1)``, ``kvcache.gather.pool_of_rows``), None for one
    pool.  The rows must hold whole pools, or lie in one pool, so that the
    shard's own rows map onto its pools as the whole batch's do."""
    if pools == 1:
        return None
    per, n = max(B // pools, 1), rows.stop - rows.start
    if rows.start % per == 0 and n % per == 0:
        return slice(rows.start // per, rows.start // per + n // per)
    if per % n == 0:
        return slice(rows.start // per, rows.start // per + 1)
    raise ValueError(f"rows {rows.start}:{rows.stop} of {B} do not fall on "
                     f"whole pools of {per} rows")


def _data_share(state: DecodeState, rows: slice, B: int,
                pooled: bool = True) -> DecodeState:
    """The decode state that a local data shard serves ``rows`` of a batch
    of B through, all views of ``state`` (its writes land there): each
    cache held a row (rings, ``h`` / ``conv``, cross K/V) its rows, along
    the batch dimension after any model-shard lead (``CacheLayout.row_dim``);
    the paged slabs shared, each row's frames its own, and with ``pooled``
    pool-partitioned slabs the pools the rows live in (``_pool_share``;
    sequence-parallel decode reads every pool for every row instead)."""
    layout = state.layout
    pools = _pool_share(layout.pools, B, rows) if pooled else None
    n_pools = layout.pools if pools is None else pools.stop - pools.start
    caches = []
    for cache in state.caches:
        view = {}
        for name, t in cache.items():
            if name not in ("k_slabs", "v_slabs", "latent"):
                view[name] = t[(slice(None),) * (1 + layout.row_dim(name))
                               + (rows,)]
            elif pools is None:
                view[name] = t
            else:                   # one pool left: no pool dimension
                at = (slice(None),) * (1 + layout.pool_dim())
                view[name] = t[at + ((pools,) if n_pools > 1
                                     else (pools.start,))]
        caches.append(view)
    return DecodeState(tuple(caches), state.seq_lens[rows],
                       dataclasses.replace(layout, pools=n_pools))


def _over_data(grid: Optional[Pods], B: int, state: DecodeState, run,
               *, pooled: bool = True) -> Tuple[torch.Tensor, DecodeState]:
    """``run(state, rows) -> (logits, state)`` once for each local data
    shard of the grid, on its rows (``_row_shares``) and its decode state
    of views (``_data_share``); once on the whole batch without a data
    axis.  Returns the shards' logits joined in row order and ``state``
    with their lengths."""
    data = None if grid is None else grid.data
    if data is None or data.local == 1:
        return run(state, slice(None))
    logits, lens = [], []
    for rows in _row_shares(data, B):
        lg, st = run(_data_share(state, rows, B, pooled), rows)
        logits.append(lg)
        lens.append(st.seq_lens)
    return (torch.cat(logits, dim=-2),
            state._replace(seq_lens=torch.cat(lens)))


def decode_on_grid(cfg: ModelConfig, params: PyTree, state: DecodeState,
                   tokens: torch.Tensor, phys_blocks: torch.Tensor,
                   grid: Optional[Pods], *, sp: bool = False
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """``decode_step`` over the grid: the rows split over the data axis (a
    call a local data shard, ``_over_data``: its rows of every cache held a
    row, its pools of pooled slabs; shared slabs through each row's own
    frames), the model axis as ``tp``, sequence parallelism over the pod
    axis with ``sp``.  Logits come as ``decode_step`` gives them (vocab
    shards over a split model axis), rows in order."""
    tp = None if grid is None else grid.model
    return _over_data(grid, tokens.shape[0], state, lambda st, rows: decode_step(
        cfg, params, st, tokens[rows], phys_blocks[rows], sp=sp, pods=grid,
        tp=tp), pooled=not sp)


def prefill_on_grid(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
                    state: DecodeState, phys_blocks: torch.Tensor,
                    grid: Optional[Pods]) -> Tuple[torch.Tensor, DecodeState]:
    """``prefill`` over the grid, split as ``decode_on_grid`` splits."""
    tp = None if grid is None else grid.model
    return _over_data(grid, tokens.shape[0], state, lambda st, rows: prefill(
        cfg, params, tokens[rows], st, phys_blocks[rows], tp=tp))


def prefill_encdec_on_grid(cfg: ModelConfig, params: PyTree,
                           enc_feats: torch.Tensor, dec_tokens: torch.Tensor,
                           state: DecodeState, phys_blocks: torch.Tensor,
                           grid: Optional[Pods]
                           ) -> Tuple[torch.Tensor, DecodeState]:
    """``prefill_encdec`` over the grid, split as ``decode_on_grid``
    splits (each data shard's clips, prompts and cross K/V rows)."""
    tp = None if grid is None else grid.model
    return _over_data(grid, dec_tokens.shape[0], state,
                      lambda st, rows: prefill_encdec(
                          cfg, params, enc_feats[rows], dec_tokens[rows], st,
                          phys_blocks[rows], tp=tp))


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
    ``step.last["logits"]`` holds the last call's logits.
    ``prologue_timer``: a list that gets a ``timed`` pair around each
    prologue.

    Where ``step_graph.graphed`` holds (the card, grad off, the default
    sampler, no SP, a grid of one data and one model shard in this
    process) the decode step and its sampling replay a CUDA graph
    (``step_graph.StepGraph``; the prologue stays outside it), and the
    logits are then the graph's own buffer, which the next replay
    overwrites."""
    if coherence not in ("none", "eager", "numapte"):
        raise ValueError(f"coherence {coherence!r}")

    def decode(params, state, tokens, phys_blocks):
        logits, state = decode_on_grid(cfg, params, state, tokens,
                                       phys_blocks, pods, sp=sp)
        with tracing.span("sample"):
            sampled = (sample or grid_sampler(params, pods))(logits)
        return logits, sampled, state

    graph = step_graph.StepGraph(decode)
    # not an attribute set from inside ``step``: a function that refers to
    # itself is freed only by the cycle collector, and so are its graphs
    last: Dict[str, torch.Tensor] = {}

    def step(params, state, tokens, phys_blocks, *coh_args):
        coh_out = None
        if coherence != "none" and coh_args:
            timer = (contextlib.nullcontext() if prologue_timer is None
                     else timed(prologue_timer, coh_args[0].device))
            with timer:
                coh_out = _coherence_prologue(coherence, pods, *coh_args)
        run = (graph if step_graph.graphed(tokens.device, pods, sp=sp,
                                           sample=sample) else decode)
        last["logits"], sampled, state = run(params, state, tokens,
                                             phys_blocks)
        if coh_out is None:
            return sampled, state
        return sampled, state, coh_out
    step.last = last
    return step


def _coherence_prologue(mode: str, pods: Pods, entries, sharers, owner,
                        mut_t, mut_i, mut_v, mut_ok, miss
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step block-table coherence over the pod axis — the paper's
    mechanism in the step.  EAGER gathers every pod's mutation buffer every
    step and applies all of it (Mitosis: one K3 launch); NUMAPTE applies
    only sharer-filtered updates and fetches misses from owners with
    degree-d prefetch (two K3 launches).  entries [p, T, epb] are updated in
    place; returns (entries, sharers).  Its span counts the bytes the
    collectives move (``pods.wire_bytes``) and the K3 launches."""
    wire, k3 = pods.wire_bytes, pte_gather.launches
    with tracing.span("coherence.prologue") as rec:
        if mode == "eager":
            out = (eager_sync(entries, mut_t, mut_i, mut_v, mut_ok, pods),
                   sharers)
        else:
            out = numapte_prologue(entries, sharers, owner, mut_t, mut_i,
                                   mut_v, mut_ok, miss, PREFETCH_DEGREE, pods)
        if rec:
            rec.counts.update(wire_bytes=pods.wire_bytes - wire,
                              k3=pte_gather.launches - k3)
    return out


def coherence_rounds(mode: str, pods: Pods, kv, timer: Optional[List] = None
                     ) -> int:
    """Prologue rounds over ``kv``'s replicas (a ``PagedKVManager`` made
    with ``replicas=True``) until nothing waits for them: what one step's
    budgets left queued.  With ``timer`` each round is ``timed`` into it.
    Returns the K3 launches the rounds made."""
    before = pte_gather.launches
    while kv.coherence_pending():
        with (timed(timer, kv.device) if timer is not None
              else contextlib.nullcontext()):
            _coherence_prologue(mode, pods, kv.replicas,
                                *kv.coherence_inputs())
    return pte_gather.launches - before


# --------------------------------------------------------------------------- cells
@dataclasses.dataclass(frozen=True)
class PerfOptions:
    """The reference's levers.  All default to the paper-faithful
    baseline."""
    decode_kernel: str = "ref"      # ref | fused_ref (the reference's model
    #                                 of its Pallas kernel's streaming)
    bf16_grads: bool = False        # differentiate a bf16 copy (``_grads``)
    seq_parallel: bool = False      # Megatron-SP: residual activations
    #                                 sharded over 'model' between blocks
    coherence: str = "none"         # none | eager | numapte: block-table
    #                                 coherence prologue on the pod axis
    remat: str = "full"             # full | dots (checkpoint policy); the
    #                                 port also takes False (none)
    compress_pod_grads: bool = False  # int8 error-feedback leg on the pods

    def tag(self) -> str:
        bits = []
        if self.decode_kernel != "ref":
            bits.append(self.decode_kernel)
        if self.bf16_grads:
            bits.append("bf16g")
        if self.seq_parallel:
            bits.append("sp")
        if self.coherence != "none":
            bits.append(self.coherence)
        if self.remat != "full":
            bits.append("remat-" + (self.remat or "none"))
        if self.compress_pod_grads:
            bits.append("int8pod")
        return "+".join(bits) or "base"


def require_options(opts: PerfOptions) -> None:
    """Refuse the options the port does not run as the reference does:
    ``decode_kernel="fused_ref"`` models the Pallas kernel's streaming,
    where the port always decodes with K1 (ValueError)."""
    if opts.decode_kernel != "ref":
        raise ValueError(f"decode_kernel {opts.decode_kernel!r}: the port "
                         "decodes with K1 (paged_attention), only 'ref'")
    if opts.coherence not in ("none", "eager", "numapte"):
        raise ValueError(f"coherence {opts.coherence!r}")
    remat_policy(opts.remat)


def build_prefill_step(cfg: ModelConfig, pods: Optional[Pods] = None
                       ) -> Callable:
    """``step(params, state, tokens, phys_blocks)`` (an encoder-decoder:
    ``step(params, state, enc_feats, dec_tokens, phys_blocks)``): a prefill
    over the grid ``pods`` (``prefill_on_grid``, or
    ``prefill_encdec_on_grid``), then greedy sampling of the last
    position's logits.  Returns (tokens [B] int32, state)."""
    sample = lambda params, logits: grid_sampler(params, pods)(logits)
    if cfg.family == "encdec":
        def step(params, state, enc_feats, dec_tokens, phys_blocks):
            logits, state = prefill_encdec_on_grid(
                cfg, params, enc_feats, dec_tokens, state, phys_blocks, pods)
            return sample(params, logits), state
        return step

    def step(params, state, tokens, phys_blocks):
        logits, state = prefill_on_grid(cfg, params, tokens, state,
                                        phys_blocks, pods)
        return sample(params, logits), state
    return step


@dataclasses.dataclass
class CellSpec:
    """One (arch x shape x grid) cell: its step and its arguments.
    ``shares``: for each leaf of ``args`` (in ``tree_leaves`` order), the
    number of devices of the grid it is split over (1: every device holds
    it whole); ``rows``: the batch rows the cell holds (the shape's global
    batch unless cut); ``cuts``: what was cut from the shape or the config,
    and why; ``seq_split``: for each stack of the step (``decoder``, and an
    encoder-decoder's ``encoder``) whether sequence parallelism splits it
    (``seq_parallel`` on, a model axis, and t dividing its length)."""
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    step_fn: Callable
    args: Tuple
    grid: Pods
    opts: PerfOptions
    shares: List[int]
    rows: int
    cuts: Dict[str, str] = dataclasses.field(default_factory=dict)
    donate: Tuple[int, ...] = ()
    seq_split: Dict[str, bool] = dataclasses.field(default_factory=dict)

    @property
    def chips(self) -> int:
        return self.grid.n * self.grid.data.n * self.grid.model.n


def seq_split(cfg: ModelConfig, shape: ShapeSpec, t: int,
              seq_parallel: bool) -> Dict[str, bool]:
    """Which stacks of a cell's step run split by sequence parallelism over
    a model axis of ``t``: the decoder's rows (a train step's S, a prefill's
    S, an encoder-decoder's ``max_decoder_len``; a decode step's one row
    never) and an encoder-decoder's S frames, each where t divides it."""
    on = lambda n: seq_splits(t, n, seq_parallel)
    enc = cfg.family == "encdec"
    rows = (1 if shape.step == "decode" else
            cfg.max_decoder_len if enc else shape.seq_len)
    out = {"decoder": on(rows)}
    if enc:
        out["encoder"] = on(shape.seq_len) and shape.step != "decode"
    return out


def _decode_geometry(cfg: ModelConfig, shape: ShapeSpec,
                     data_size: int) -> Tuple[int, int, int]:
    """(n_frames, max_blocks_per_seq, n_pools)."""
    bt = cfg.kv_block_tokens
    mb = -(-shape.seq_len // bt) + 1
    mb = -(-mb // data_size) * data_size     # SP shards table columns evenly
    n_frames = shape.global_batch * mb
    n_pools = data_size
    n_frames = -(-n_frames // n_pools) * n_pools      # divisible pool split
    return n_frames, mb, n_pools


#: the reference's per-step coherence budgets (``BlockTableSpec``'s
#: defaults) and its table size
MUTATION_BUDGET, MISS_BUDGET, TABLE_ENTRIES = (
    BlockTableSpec.mutation_budget, BlockTableSpec.miss_budget, ENTRIES_PER_TABLE)


def _row_share(rows: int, data_size: int) -> int:
    """Devices the rows split over: the data size when it divides them
    (the reference's ``_divisible``), else 1 (replicated)."""
    return data_size if rows % data_size == 0 else 1


def _state_shares(state: DecodeState, row_share: int) -> List[int]:
    """The ``shares`` of a decode state's leaves, from its ``layout``: the
    paged slabs over their pools (one pool a device of the pod and data
    axes) and their kv heads' split, the caches held a row over the rows
    and over their split (the kv heads' for rings and cross K/V, the
    recurrent layers' for ``h`` / ``conv``) and ``seq_lens`` over the rows
    (the layout record is the state's structure, not a leaf)."""
    lay = state.layout
    shares = []
    for cache in state.caches:
        for name in cache:
            if name in ("k_slabs", "v_slabs", "latent"):
                shares.append(lay.pools * lay.kv_split)
            elif name in ("h", "conv"):
                shares.append(row_share * lay.state_split)
            else:                       # rings, cross K/V
                shares.append(row_share * lay.kv_split)
    return shares + [row_share]


def _tensor(shape, dtype, device, gen: Optional[torch.Generator],
            high: Optional[int] = None) -> torch.Tensor:
    """An argument of a cell: empty on the meta device; on a real device
    drawn from ``gen`` (ids below ``high``, or standard normals)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if high is not None:
        return torch.randint(0, high, shape, generator=gen, device=device,
                             dtype=dtype)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def build_cell(arch: str, shape: ShapeSpec, grid: Pods, *,
               opts: Optional[PerfOptions] = None, device: DeviceLike = "meta",
               rows: Optional[int] = None, n_layers: Optional[int] = None,
               cfg: Optional[ModelConfig] = None) -> CellSpec:
    """The cell of ``arch`` at ``shape`` on ``grid`` (its pod axis carrying
    ``.data`` and ``.model``).  On the meta device (the default) ``args``
    are the port's argument trees with nothing drawn or allocated:

      * train: (parameters split by ``shard_params``, their AdamW state,
        the batch ``{"tokens": [B, S+1]}``, an encoder-decoder's
        ``enc_feats`` [B, S, D] bf16 and its ``max_decoder_len + 1``
        tokens), and the int8 leg's error buffers with
        ``compress_pod_grads`` on several pods;
      * prefill: (parameters, the decode state, tokens [B, S] (an
        encoder-decoder: ``enc_feats``, ``dec_tokens`` [B,
        max_decoder_len]), block tables [B, mb]);
      * decode: (parameters, the decode state, tokens [B], block tables
        [B, mb]) and, with a coherence mode on several pods, the
        prologue's replicas [P, T, 512] and buffers (1 024 mutations and
        256 misses a pod).

    The geometry is ``_decode_geometry``'s over the pod and data axes
    (one KV pool each); decode is sequence-parallel where the rows are
    fewer than the pools.  On a real ``device`` the arguments are drawn
    from seed 0 (weights as ``init_params``; a decode state holding
    ``seq_len`` tokens a row, an encoder-decoder's decoder at most
    ``max_decoder_len``, each row its own frames in its pool,
    ``_cell_tables``), ``rows`` cuts the batch and ``n_layers`` the depth
    (named in ``cuts``); ``cfg`` replaces the arch's published config (a
    smoke config in the tests).  ``step_fn`` is the port's step over
    ``grid``: ``build_train_step``, ``build_prefill_step`` or
    ``build_serve_step``, which run every option of the grid; a decode or
    prefill step raises a ValueError where its rows do not split over the
    data axis (``_row_shares``) or a data shard's rows over whole pools
    (``_pool_share``).  With ``opts.seq_parallel`` the train and prefill
    steps run Megatron sequence parallelism over the model axis
    (``seq_split`` says where)."""
    opts = opts or PerfOptions()
    require_options(opts)
    device = resolve_device(device)
    cfg = cfg or get_config(arch)
    cuts: Dict[str, str] = {}
    if n_layers is not None and n_layers != cfg.n_layers:
        cuts["n_layers"] = f"{n_layers} of {cfg.n_layers}"
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gb = shape.global_batch if rows is None else rows
    if gb != shape.global_batch:
        cuts["rows"] = f"{gb} of {shape.global_batch}"
    S, t = shape.seq_len, grid.model.n
    data_size = grid.n * grid.data.n
    row_share = _row_share(gb, data_size)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(0))
    params = (_meta_params(cfg, grid.n, grid.data.n, t) if gen is None
              else shard_params(init_params(cfg, gen), grid, cfg))
    p_shares = [t if s else 1 for s in split_leaves(params)]
    i32 = torch.int32
    step_fn = functools.partial(_cell_step, cfg, grid, opts, shape.step)
    enc = cfg.family == "encdec"
    split = seq_split(cfg, shape, t, opts.seq_parallel)

    if shape.step == "train":
        opt = adamw_init(params)
        if enc:
            batch = {"enc_feats": _tensor((gb, S, cfg.d_model), torch.bfloat16,
                                          device, gen),
                     "tokens": _tensor((gb, cfg.max_decoder_len + 1), i32,
                                       device, gen, cfg.vocab_size)}
        else:
            batch = {"tokens": _tensor((gb, S + 1), i32, device, gen,
                                       cfg.vocab_size)}
        args = (params, opt, batch)
        shares = p_shares + [1] + p_shares * 2 + [row_share] * len(batch)
        if opts.compress_pod_grads and grid.n > 1:
            ef = tree_map(lambda p: torch.zeros((grid.local,) + tuple(p.shape),
                                                dtype=torch.float32,
                                                device=device), params)
            args = args + (ef,)
            shares += [grid.n * s for s in p_shares]
        return CellSpec(arch, shape, cfg, step_fn, args, grid, opts, shares,
                        gb, cuts, donate=(0, 1), seq_split=split)

    n_frames, mb, n_pools = _decode_geometry(
        cfg, dataclasses.replace(shape, global_batch=gb), data_size)
    sp = shape.step == "decode" and gb < data_size
    state = init_decode_state(cfg, gb, n_frames, mb, enc_len=S if enc else 0,
                              n_pools=n_pools, kv_split=kv_split(cfg, grid),
                              state_split=state_split(params, grid),
                              device=device)
    state_shares = _state_shares(state, row_share)
    tables = (torch.empty((gb, mb), dtype=i32, device=device)
              if device.type == "meta"
              else _cell_tables(gb, mb, n_frames, n_pools, sp, device))

    if shape.step == "prefill":
        if enc:
            args = (params, state,
                    _tensor((gb, S, cfg.d_model), torch.bfloat16, device, gen),
                    _tensor((gb, cfg.max_decoder_len), i32, device, gen,
                            cfg.vocab_size), tables)
            inputs = [row_share] * 3
        else:
            args = (params, state,
                    _tensor((gb, S), i32, device, gen, cfg.vocab_size), tables)
            inputs = [row_share] * 2
        return CellSpec(arch, shape, cfg, step_fn, args, grid, opts,
                        p_shares + state_shares + inputs, gb, cuts,
                        donate=(1,), seq_split=split)

    if device.type != "meta":                 # a context of S tokens a row
        state.seq_lens.fill_(min(S, cfg.max_decoder_len) if enc else S)
    tokens = _tensor((gb,), i32, device, gen, cfg.vocab_size)
    args = (params, state, tokens, tables)
    inputs = [1, n_pools] if sp else [row_share, row_share]
    if opts.coherence != "none" and grid.n > 1:
        P, T = grid.n, max(1, -(-n_frames // TABLE_ENTRIES))
        M, Q = MUTATION_BUDGET, MISS_BUDGET
        empty = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        args = args + (empty((P, T, TABLE_ENTRIES), i32),
                       empty((T,), torch.int64), empty((T,), i32),
                       empty((P, M), i32), empty((P, M), i32),
                       empty((P, M), i32), empty((P, M), torch.bool),
                       empty((P, Q), i32))
        inputs += [P, 1, 1, P, P, P, P, P]
    return CellSpec(arch, shape, cfg,
                    functools.partial(step_fn, sp=sp), args, grid, opts,
                    p_shares + state_shares + inputs, gb, cuts, donate=(1,),
                    seq_split=split)


def _cell_tables(rows: int, mb: int, n_frames: int, n_pools: int, sp: bool,
                 device: torch.device) -> torch.Tensor:
    """A cell's block tables [rows, mb] on a real device, each row its own
    frames, local to the pool that holds them: a row's frames in its pool
    (``kvcache.gather.pool_of_rows``) one after another, or under
    sequence parallelism column c of every row in pool ``c // (mb /
    n_pools)`` (``sp_tables``).  Flattened to global ids the rows' layout
    gives row b frames ``b * mb .. b * mb + mb - 1`` when the pools hold
    ``rows * mb`` frames, as one pool does."""
    f_local = n_frames // n_pools
    b = torch.arange(rows, device=device)[:, None]
    c = torch.arange(mb, device=device)[None, :]
    if sp:
        mbl = mb // n_pools
        local = b * mbl + c % mbl
    else:
        per = max(rows // n_pools, 1)
        local = (b % per) * mb + c
        if n_pools > 1:
            pool_of_rows(rows, n_pools)          # rows past the pools raise
    if int(local.max()) >= f_local:
        raise ValueError(f"{rows} rows of {mb} frames do not fit {n_pools} "
                         f"pools of {f_local}")
    return local.to(torch.int32)


@functools.lru_cache(maxsize=8)
def _meta_params(cfg: ModelConfig, pods: int, data: int, model: int) -> PyTree:
    """``shard_params`` of ``cfg``'s meta parameters over a (pods, data,
    model) grid; the cells of one arch on one grid share the tree (meta
    tensors hold no data)."""
    grid = make_debug_mesh(pods, data=data, model=model, device="meta")
    return shard_params(init_params(cfg, SHAPES_ONLY), grid, cfg)


def _cell_step(cfg: ModelConfig, grid: Pods, opts: PerfOptions, step: str,
               *args, sp: bool = False):
    """A cell's step: the port's step builder over ``grid``, called (a
    train step on a grid of one device runs without one: the pod and data
    legs would only copy its gradients), under the rules of ``opts``
    (``make_rules``: ``seq_parallel`` reaches the train and prefill steps;
    a decode step's one row never splits)."""
    with use_rules(make_rules(cfg, grid, opts)):
        if step == "train":
            one = grid.n * grid.data.n * grid.model.n == 1
            return build_train_step(cfg, opts.compress_pod_grads,
                                    pods=None if one else grid,
                                    remat=opts.remat,
                                    bf16_grads=opts.bf16_grads)(*args)
        if step == "prefill":
            return build_prefill_step(cfg, pods=grid)(*args)
        return build_serve_step(cfg, sp=sp, coherence=opts.coherence,
                                pods=grid)(*args)
