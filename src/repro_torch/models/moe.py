"""Mixture-of-experts FFN: top-k routing with a per-expert capacity.

Sort-based capacity dispatch with static shapes, as the reference computes
it: the N*k assignments are ranked within their expert by a stable sort, and
those beyond the per-expert capacity C are dropped (Switch-style).  The
experts run as three batched products over ``[E, C, D]``; every expert's
weights are read whatever its load.  Plain PyTorch on both devices (the
reference computes it in plain jnp, outside any kernel).

Two choices keep the routes and outputs those of the reference on every
device:
  * top-k is the first k of a *stable* descending sort, so that at a tie the
    lower expert id wins, as ``jax.lax.top_k`` picks it (``torch.topk``
    promises no order among equals);
  * the combine gathers each token's kept results and adds them in ascending
    expert order in ``cfg.dtype``, the order in which the reference's
    scatter-add rounds them; an ``index_add_`` would add in a different
    order on each CUDA run.

Over the grid's ``model`` axis (``tp``; the reference's ``experts`` rule)
the layer is expert-parallel: ``we_in``/``we_gate``/``we_out`` hold each
local shard's E/t experts ``[p, E/t, ...]`` and ``router`` its E/t columns.
Each shard computes its columns of the router logits; one all-gather gives
every shard the whole ``[N, E]``, so every shard takes the same top-k,
capacity and dispatch.  Each shard runs its experts' slots and gathers its
partial combine (its experts' results, in ascending expert order, zeros for
the others'), a ``shared`` expert split by ``ff`` adds its partial, and one
``tp.psum`` sums the partials in ``cfg.dtype``: the reference's one
scatter-add becomes a sum of per-shard sums (only the order of the
``cfg.dtype`` additions differs).  The aux loss comes from the gathered
probabilities, replicated, and is not summed over the axis.

DeepSeek-V3's experts (``cfg.moe_router == "sigmoid"``, Moonlight's) route
on float32 logits and sigmoid scores: the top k are taken on the scores plus
a per-expert correction bias (``router_bias``, the noaux_tc rule; ties to the
lower id), and the gates are the chosen unbiased scores over their sum,
times ``cfg.moe_routed_scale``; there is no aux loss.  With
``cfg.moe_dropless`` no assignment is ever dropped: a decode step (one
token a row) runs the batched products at capacity = its tokens, static
shapes that a CUDA graph captures; a longer call (prefill, training) runs
over expert-sorted segments, one product an expert, ``DROPLESS_CHUNK``
tokens at a time, and reads the experts' loads on the host once a chunk.

Spans: ``moe`` holds ``moe.route`` {``assignments``}, ``moe.experts``
{``experts``, ``rows``: the experts run and the rows their products compute;
over segments also ``load_max``, the largest load} and ``moe.shared``.  A
segmented call on the card drains the stream before its ``moe`` span opens
and before it closes, while spans record (the segments read the loads on
the host anyway): the device time inside the span is then the layer's own.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import tracing
from ..distributed.pods import Pods
from .common import ModelConfig, _dense, activation, ffn_has_gate
from .ffn import ffn_forward, init_ffn

CAPACITY_FACTOR = 1.25
#: tokens a dropless segmented call routes and runs at once (its gathered
#: rows and hidden activations stay under ~1 GB at Moonlight's widths)
DROPLESS_CHUNK = 32768


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype
             ) -> Dict[str, object]:
    """``router`` [D,E] (scale 0.1), ``we_in``/``we_gate`` [E,D,F],
    ``we_out`` [E,F,D], a sigmoid router's ``router_bias`` [E] (scale
    0.01) and, with shared experts, a dense ``shared`` FFN of width
    ``moe_d_ff * n_shared_experts``.  The expert tensors take the
    reference's fan-in, ``shape[0]`` = E."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p: Dict[str, object] = {
        "router": _dense(gen, (d, e), dtype, scale=0.1),
        "we_in": _dense(gen, (e, d, f), dtype),
        "we_out": _dense(gen, (e, f, d), dtype),
    }
    if ffn_has_gate(cfg.ffn_act):
        p["we_gate"] = _dense(gen, (e, d, f), dtype)
    if cfg.moe_router == "sigmoid":
        p["router_bias"] = _dense(gen, (e,), dtype, scale=0.01)
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(cfg, gen, dtype,
                               d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    factor: float = CAPACITY_FACTOR) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference does


class Routes(NamedTuple):
    probs: torch.Tensor     # [N,E] float32 softmax (or sigmoid) of the router
    eids: torch.Tensor      # [N,k] int64 expert ids, by falling probability
    gates: torch.Tensor     # [N,k] float32, renormalised over the k


def route(cfg: ModelConfig, p: Dict[str, torch.Tensor], xf: torch.Tensor,
          logits: Optional[torch.Tensor] = None) -> Routes:
    """Router product in ``cfg.dtype`` (or its given ``logits`` [N,E]),
    softmax in float32, top-k as the first k of a stable descending sort
    (ties go to the lower expert id).  A sigmoid router: ``_route_sigmoid``."""
    if cfg.moe_router == "sigmoid":
        return _route_sigmoid(cfg, p, xf, logits)
    if logits is None:
        logits = xf @ p["router"].to(cfg.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates = vals[:, :k]
    return Routes(probs, idx[:, :k], gates / gates.sum(dim=-1, keepdim=True))


def _route_sigmoid(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                   xf: torch.Tensor, logits: Optional[torch.Tensor] = None
                   ) -> Routes:
    """DeepSeek-V3's noaux_tc routing: float32 logits (the router product
    in float32, or the given ``logits``), sigmoid scores, the top k of
    score + ``router_bias`` by a stable descending sort (ties to the lower
    id), gates the chosen scores over their sum times
    ``cfg.moe_routed_scale``."""
    if logits is None:
        logits = xf.float() @ p["router"].float()
    scores = torch.sigmoid(logits.float())
    _, idx = torch.sort(scores + p["router_bias"].float(), dim=-1,
                        descending=True, stable=True)
    eids = idx[:, :cfg.experts_per_token]
    picked = scores.gather(1, eids)
    gates = picked / picked.sum(dim=-1, keepdim=True) * cfg.moe_routed_scale
    return Routes(scores, eids, gates)


# Two runs that round differently (the two frameworks in bfloat16, or the
# kernel path against the plain one) see hidden states an ulp or two apart,
# so they may pick different experts, but only where the two experts' router
# probabilities lie within NEAR_TIE of the larger: two bf16 steps of a router
# logit of order one.
NEAR_TIE = 2.0 ** -7


def route_flips(probs: torch.Tensor, mine: torch.Tensor, theirs: torch.Tensor
                ) -> Tuple[int, float]:
    """Between two runs' expert ids ``mine`` and ``theirs`` [N,k] of one MoE
    call: the number of ``mine`` that ``theirs`` lacks, and the largest gap,
    relative to the larger and under ``probs`` [N,E], between an expert one
    run took and the other left (0.0 where the routes agree).  A gap below
    ``NEAR_TIE`` is a near-tie."""
    mine, theirs = mine.cpu(), theirs.cpu()
    differ = (mine.sort(-1).values != theirs.sort(-1).values).any(-1)
    flips, gap = 0, 0.0
    for p, a, b in zip(probs.cpu()[differ].tolist(), mine[differ].tolist(),
                       theirs[differ].tolist()):
        took, left = set(a) - set(b), set(b) - set(a)
        flips += len(took)
        for x in took:
            for y in left:
                gap = max(gap, abs(p[x] - p[y]) / max(p[x], p[y]))
    return flips, gap


class Dispatch(NamedTuple):
    tok: torch.Tensor       # [E,C] int64 token of each slot, N where empty
    w: torch.Tensor         # [E,C] float32 gate of each slot, 0 where empty
    slot: torch.Tensor      # [N,k] int64 slot e*C + rank of each assignment,
                            #       E*C where it was dropped


def dispatch(routes: Routes, n_experts: int, capacity: int) -> Dispatch:
    """Stable sort of the N*k assignments by expert; an assignment's rank is
    its place among its expert's, and those of rank >= capacity drop.
    Within an expert the sort keeps token order, so rows later in the batch
    (a partial wave's padding) never displace an earlier row."""
    N, K = routes.eids.shape
    E, C = n_experts, capacity
    dev = routes.eids.device
    flat_e = routes.eids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, torch.arange(E, device=dev), right=False)
    rank = torch.arange(N * K, device=dev) - first[se]
    slot_sorted = torch.where(rank < C, se * C + rank,
                              torch.full_like(rank, E * C))
    tok = torch.full((E * C + 1,), N, dtype=torch.int64, device=dev)
    tok[slot_sorted] = order // K              # the sentinel slot is cut off
    w = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    w[slot_sorted] = routes.gates.reshape(-1)[order]
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return Dispatch(tok[:-1].reshape(E, C), w[:-1].reshape(E, C),
                    slot.reshape(N, K))


def _aux_loss(routes: Routes, E: int) -> torch.Tensor:
    """The Switch load-balance loss of one call's routes (counts by a
    scatter, which unlike bincount does not wait for the card)."""
    N = routes.eids.shape[0]
    flat = routes.eids.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    return E * torch.sum(routes.probs.mean(dim=0) * (counts / N))


def _experts(cfg: ModelConfig, p: Dict[str, torch.Tensor], xf: torch.Tensor,
             disp: Dispatch, routes: Routes, first: int = 0) -> torch.Tensor:
    """The experts ``first``, ``first`` + 1, ... held in ``p`` (all E, or
    a shard's E/t) over their rows of the dispatch, and the combine of
    their results [N, D]: each token's kept results among these experts,
    added in ascending expert order in ``cfg.dtype`` (as the reference's
    scatter-add adds them); a dropped assignment, or one to an expert held
    elsewhere, adds the zero row.  Three batched products over the
    experts' C slots; each activation is freed once the next product has it
    (at full-width prefill xe alone is 1.3-2.4 GB)."""
    N, D = xf.shape
    Eh, C = p["we_in"].shape[0], disp.tok.shape[1]
    x_pad = torch.cat([xf, xf.new_zeros((1, D))])
    xe = x_pad[disp.tok[first:first + Eh]]                   # [Eh,C,D]
    h = torch.bmm(xe, p["we_in"].to(cfg.dtype))
    gate = torch.bmm(xe, p["we_gate"].to(cfg.dtype)) if "we_gate" in p else None
    del xe
    h = activation(cfg.ffn_act, h, gate)
    del gate
    ye = torch.bmm(h, p["we_out"].to(cfg.dtype))
    del h
    w = disp.w[first:first + Eh, :, None].to(cfg.dtype)
    ye = (ye * w).reshape(Eh * C, D)
    ye = torch.cat([ye, ye.new_zeros((1, D))])     # the sentinel slot Eh*C
    by_expert = torch.argsort(routes.eids, dim=-1)
    slots = torch.gather(disp.slot, 1, by_expert) - first * C       # [N,k]
    slots = torch.where((slots >= 0) & (slots < Eh * C), slots,
                        torch.full_like(slots, Eh * C))
    out = ye[slots[:, 0]]
    for j in range(1, slots.shape[1]):
        out = out + ye[slots[:, j]]
    return out


def _segments(cfg: ModelConfig, p: Dict[str, torch.Tensor], xf: torch.Tensor,
              routes: Routes) -> Tuple[torch.Tensor, List[int]]:
    """The dropless experts over expert-sorted segments: the N*k
    assignments sorted by expert (stable: token order within an expert),
    one product chain an expert on its rows, each result scaled by its
    gate, then each token's k results added in ascending expert order in
    ``cfg.dtype`` (as ``_experts`` adds them).  Reads the experts' loads on
    the host.  Returns (out [N, D], the loads [E])."""
    N, D = xf.shape
    K = routes.eids.shape[1]
    flat = routes.eids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    loads = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    gates = routes.gates.reshape(-1)[order].to(cfg.dtype)
    ye = torch.empty((N * K, D), dtype=cfg.dtype, device=xf.device)
    start = 0
    for e, n in enumerate(loads):
        if n == 0:
            continue
        rows = order[start:start + n]
        xe = xf[rows // K]
        h = xe @ p["we_in"][e].to(cfg.dtype)
        gate = xe @ p["we_gate"][e].to(cfg.dtype) if "we_gate" in p else None
        del xe
        h = activation(cfg.ffn_act, h, gate)
        del gate
        ye[start:start + n] = (h @ p["we_out"][e].to(cfg.dtype)) * gates[
            start:start + n, None]
        start += n
    # sorted position of assignment (t, j), then each token's by expert id
    pos = torch.empty_like(order)
    pos[order] = torch.arange(N * K, device=xf.device)
    pos = torch.gather(pos.view(N, K), 1, torch.argsort(routes.eids, dim=-1))
    out = ye[pos[:, 0]]
    for j in range(1, K):
        out = out + ye[pos[:, j]]
    return out, loads


def _dropless(cfg: ModelConfig, p: Dict[str, torch.Tensor], xf: torch.Tensor,
              xe: torch.Tensor) -> torch.Tensor:
    """The routed experts of a dropless call longer than a decode step
    (module doc), routed on xf [N, D] and run on xe (the same rows in
    ``cfg.dtype``) -> [N, D]: in segments, ``DROPLESS_CHUNK`` tokens at a
    time."""
    K, outs = cfg.experts_per_token, []
    for c0 in range(0, xf.shape[0], DROPLESS_CHUNK):
        x = xf[c0:c0 + DROPLESS_CHUNK]
        with tracing.span("moe.route", assignments=x.shape[0] * K):
            routes = route(cfg, p, x)
        with tracing.span("moe.experts") as rec:
            out, loads = _segments(cfg, p, xe[c0:c0 + DROPLESS_CHUNK], routes)
            if rec:
                rec.counts.update(experts=sum(n > 0 for n in loads),
                                  rows=x.shape[0] * K, load_max=max(loads))
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def moe_forward(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                tp: Optional[Pods] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (out [B,S,D] in ``cfg.dtype``, aux: the Switch
    load-balance loss, a float32 scalar; 0 for a sigmoid router).  A float32
    x (a float32 residual's norm) is routed as it is and rounded to
    ``cfg.dtype`` for the experts.  Capacity comes from the N = B*S tokens
    of this call; a dropless layer has none (module doc).
    ``tp``: the model axis (expert-parallel when the experts are split over
    it: module doc)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    N = B * S
    xf = x.reshape(N, D)
    xe = xf.to(cfg.dtype)
    C = expert_capacity(N, E, K, cfg.moe_capacity_factor)
    if tp is not None and p["we_in"].dim() == 4:
        if cfg.moe_dropless or cfg.moe_router != "softmax":
            raise ValueError(f"{cfg.name}: dropless or sigmoid-routed experts "
                             "are not split over the model axis")
        return _moe_tp(cfg, p, x, C, tp)
    segmented = cfg.moe_dropless and S > 1
    drain = segmented and x.is_cuda and tracing.on()
    if drain:
        torch.cuda.synchronize(x.device)
    with tracing.span("moe"):
        if segmented:
            out = _dropless(cfg, p, xf, xe)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            if cfg.moe_dropless:            # decode: capacity = its tokens
                C = N
            with tracing.span("moe.route", assignments=N * K):
                routes = route(cfg, p, xf)
                aux = (_aux_loss(routes, E) if cfg.moe_router == "softmax"
                       else torch.zeros((), dtype=torch.float32,
                                        device=x.device))
            with tracing.span("moe.experts", experts=E, rows=E * C):
                out = _experts(cfg, p, xe, dispatch(routes, E, C), routes)
        if cfg.n_shared_experts:
            with tracing.span("moe.shared"):
                out = out + ffn_forward(cfg, p["shared"], xe[None], tp)[0]
        if drain:
            torch.cuda.synchronize(x.device)
    return out.reshape(B, S, D), aux


def _moe_tp(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
            C: int, tp: Pods) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel layer over ``tp`` (module doc) of x [B,S,D]: the
    combined output [B,S,D], replicated (each shard's rows of it under
    sequence parallelism: ``tp.block_out``), and the aux loss.  The aux
    loss is taken once, on shard 0's routes: on a rank without shard 0 it
    is that rank's equal value, detached, so that the all-gather's backward
    (a sum over the shards) counts its gradient once."""
    E = cfg.n_experts
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    xin = tp.block_in(xf)
    local = torch.stack([xin[i] @ p["router"][i].to(cfg.dtype)
                         for i in range(tp.local)])          # [p, N, E/t]
    gathered = tp.all_gather(local)                           # [p, t, N, E/t]
    shared = p.get("shared")
    split_shared = shared is not None and shared["w_in"].dim() == 3
    aux, parts = None, []
    for i, shard in enumerate(tp.local_indices()):
        logits = gathered[i].movedim(0, -2).flatten(-2)        # [N, E]
        routes = route(cfg, p, xin[i], logits=logits)
        if i == 0:
            aux = _aux_loss(routes, E)
            if shard != 0:
                aux = aux.detach()
        mine = {k: p[k][i] for k in ("we_in", "we_gate", "we_out") if k in p}
        part = _experts(cfg, mine, xin[i], dispatch(routes, E, C), routes,
                        first=shard * p["we_in"].shape[1])
        if split_shared:
            part = part + ffn_forward(cfg, {k: w[i] for k, w in shared.items()},
                                      xin[i][None])[0]
        parts.append(part)
    out = tp.block_out(torch.stack(parts).unflatten(1, (B, S)))
    if shared is not None and not split_shared:
        out = out + tp.block_extra(
            ffn_forward(cfg, shared, xf[None])[0].reshape(B, S, D))
    return out, aux
