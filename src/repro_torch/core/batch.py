"""Batched access-stream engine: `NumaSim.touch` over whole NumPy arrays.

The scalar path (``NumaSim.touch``) pays CPython dispatch for every single
page access, which forces the app benchmarks to shrink datasets ~256x.
This module replays *identical* protocol semantics over arrays, so paper
scale access streams become practical, and the differential tests can hold
the two paths to byte-identical counters and modeled nanoseconds.

Grouping strategy
-----------------
A batch is the access stream of ONE thread, in program order.  Ordering is
what makes exactness subtle: TLB fills are FIFO (so hit/miss classification
depends on every prior miss), faults install PTEs (so later accesses to the
same leaf table may walk instead of fault), and modeled time is a float that
must be accumulated with the same IEEE operation sequence as the scalar path.
The engine therefore splits a batch into per-(thread, leaf-table) groups and
picks, per group, the fastest strategy that is still provably exact:

* **Bulk first-touch groups** — the batch slice is strictly increasing, its
  leaf table does not exist yet, and one VMA covers the whole slice.  Then
  every access is a compulsory fault with a constant per-access cost, the
  FIFO TLB evolution has a closed form (evict ``max(0, len+k-cap)`` oldest
  entries, append the k new fills), and the PTE/oracle/sharer updates are
  bulk dict merges.  Modeled time is charged as ``first + (k-1)*rest`` which
  is bit-equal to the scalar add sequence because every participating cost
  constant is integer-valued (guarded at runtime; non-integer cost models
  fall back to the general loop).
* **General groups** — a single tight interpreter loop with all hot state
  (TLB dict, table store, oracle, cost constants, per-node charge tables)
  bound to locals.  It performs exactly the scalar path's dict operations
  and float additions in the same order — TLB hit, local/remote walk,
  failed walk, on-demand PTE copy, degree-d prefetch, replica install with
  sharer-mask update, first-touch allocation — but amortizes attribute
  lookups, VMA resolution (one sorted interval index per batch instead of a
  linear scan per fault) and counter flushes across the whole batch.

Unsorted batches skip grouping and run through the general loop directly.
Counters are accumulated in local ints and flushed once (integer addition is
order-free); thread time is accumulated in a local float with the exact same
addition sequence the scalar path would perform.

Assumptions (both hold for every workload in this repo and are the scalar
path's own operating regime): VMAs are disjoint, and TLBs only cache mapped
translations (invariant I4).
"""
from __future__ import annotations

import operator
from itertools import islice, repeat
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.fifo_miss import fifo_miss
from .pagetable import (LEAF_SHIFT, PTE, PTES_PER_TABLE, Policy,
                        find_vma_sorted)

__all__ = ["touch_batch", "access_stream", "group_by_leaf"]

_IDX_MASK = PTES_PER_TABLE - 1
#: beyond this magnitude float addition of integers can round; fall back.
_MAX_EXACT = float(1 << 52)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def touch_batch(sim, tid: int, vpns, write_mask=None, *,
                return_frames: bool = False):
    """Equivalent of ``for v in vpns: sim.touch(tid, v)`` — but batched.

    ``write_mask`` is accepted for API symmetry with ``touch(write=...)``;
    like the scalar path, writes do not change classification or cost.
    Returns the number of accesses processed, or the per-access frame ids
    (as ``np.int64``) when ``return_frames`` is set.  A mid-batch access to
    an unmapped vpn raises ``SegfaultError`` after applying exactly the
    partial state the scalar loop would have left behind.
    """
    arr = np.asarray(vpns, dtype=np.int64).ravel()
    n = int(arr.size)
    frames: Optional[List[int]] = [] if return_frames else None
    if n and sim.elide_flushes and (
            sim._free_frames
            or any(p.lazy_pages for p in sim.processes.values())):
        # Lazy-invalidation mode with reuse state pending: a touch can pop
        # a pooled frame or force a deferred shootdown mid-stream (which
        # charges *other* threads), neither of which the grouped fast
        # paths can express.  Run the scalar reference loop — by
        # construction byte-identical to it.  With no pooled frames and
        # no marks the fast paths below are exact even under elision.
        return _touch_scalar(sim, tid, arr, write_mask, frames)
    if n:
        ctx = _BatchContext(sim, tid)
        if n == 1 or bool(np.all(arr[1:] > arr[:-1])):
            # strictly increasing: per-(thread, leaf-table) groups, with the
            # closed-form bulk path for fresh tables.
            for group in group_by_leaf(arr):
                if not _bulk_first_touch(ctx, group, frames):
                    _general(ctx, group, frames)
        else:
            _general(ctx, arr, frames)
    if return_frames:
        return np.asarray(frames, dtype=np.int64)
    return n


def group_by_leaf(arr: np.ndarray) -> List[np.ndarray]:
    """Split a strictly-increasing vpn array into per-leaf-table runs.

    This is the engine's grouping primitive (one group per consecutive
    run of accesses that land on the same leaf table), exposed publicly
    so the trace compiler (``repro_torch.core.trace``) lowers touch payloads
    through the exact same grouping the access engine replays them
    with."""
    cuts = np.flatnonzero(np.diff(arr >> LEAF_SHIFT)) + 1
    return np.split(arr, cuts)


def _touch_scalar(sim, tid: int, arr: np.ndarray, write_mask,
                  frames: Optional[List[int]]):
    """The literal scalar reference loop (elision fallback path)."""
    if write_mask is None:
        writes: Iterable = repeat(False, int(arr.size))
    elif np.isscalar(write_mask) or getattr(write_mask, "ndim", 1) == 0:
        writes = repeat(bool(write_mask), int(arr.size))
    else:
        writes = (bool(w) for w in np.asarray(write_mask).ravel())
    touch = sim.touch
    if frames is None:
        for vpn, w in zip(arr.tolist(), writes):
            touch(tid, vpn, write=w)
        return int(arr.size)
    for vpn, w in zip(arr.tolist(), writes):
        frames.append(touch(tid, vpn, write=w))
    return np.asarray(frames, dtype=np.int64)


def access_stream(sim, chunks: Iterable[Sequence]) -> Dict[int, float]:
    """Run ``(tid, vpns[, write_mask])`` chunks in order through the batch
    engine.  Returns the modeled nanoseconds each thread consumed."""
    before: Dict[int, float] = {}
    for chunk in chunks:
        tid, vpns = chunk[0], chunk[1]
        mask = chunk[2] if len(chunk) > 2 else None
        if tid not in before:
            before[tid] = sim.threads[tid].time_ns
        touch_batch(sim, tid, vpns, mask)
    return {tid: sim.threads[tid].time_ns - t0 for tid, t0 in before.items()}


# --------------------------------------------------------------------------
# shared per-batch context
# --------------------------------------------------------------------------
class _BatchContext:
    """Per-batch bindings: thread, node, TLB, charge tables, VMA index."""

    __slots__ = ("sim", "tid", "thr", "node", "proc", "tlb", "local_mem",
                 "remote_ns", "fail_ns", "_vma_starts", "_vmas_sorted")

    def __init__(self, sim, tid: int):
        self.sim = sim
        self.tid = tid
        thr = sim.threads[tid]
        self.thr = thr
        node = sim.topo.node_of_cpu(thr.cpu)
        self.node = node
        # all address-space state (VMAs, tables, oracle, TLB partition) is
        # the thread's process's — other tenants on the same CPU are
        # invisible to a data-access batch.
        self.proc = sim.processes[thr.asid]
        self.tlb = sim._asid_tlbs[thr.asid][thr.cpu]
        c = sim.cost
        interf = sim._interference
        lm, rm, mult = c.local_mem_ns, c.remote_mem_ns, c.interference_mult
        self.local_mem = lm
        # per-node charge for a remote walk / remote data access (with the
        # interference multiplier exactly as CostModel.walk_cost_ns applies
        # it) and for a *failed* walk (never charged interference).
        self.remote_ns = [lm if m == node else
                          (rm * mult if (m in interf or node in interf)
                           else rm)
                          for m in range(sim.topo.n_nodes)]
        self.fail_ns = [lm if m == node else rm
                        for m in range(sim.topo.n_nodes)]
        self._vma_starts: Optional[List[int]] = None
        self._vmas_sorted: List = []

    def vma_at(self, vpn: int):
        """find_vma over a sorted interval index (VMAs are disjoint)."""
        if self._vma_starts is None:
            self._vmas_sorted = sorted(self.proc.vmas,
                                       key=operator.attrgetter("start_vpn"))
            self._vma_starts = [v.start_vpn for v in self._vmas_sorted]
        return find_vma_sorted(self._vmas_sorted, self._vma_starts, vpn)


# --------------------------------------------------------------------------
# bulk path: fresh-table first-touch groups
# --------------------------------------------------------------------------
def _bulk_first_touch(ctx: _BatchContext, g: np.ndarray,
                      frames_out: Optional[List[int]]) -> bool:
    """Closed-form handling of a strictly-increasing group whose leaf table
    does not exist yet.  Returns False (untouched state) when any exactness
    precondition fails, so the caller can run the general loop instead."""
    sim = ctx.sim
    ti = int(g[0]) >> LEAF_SHIFT
    store = ctx.proc.store
    if store.tables.get(ti) is not None:
        return False
    vma = ctx.vma_at(int(g[0]))
    if vma is None or int(g[-1]) >= vma.end_vpn:
        return False
    thr, node = ctx.thr, ctx.node
    t = thr.time_ns
    c = sim.cost
    nn = sim.topo.n_nodes
    policy = sim.policy
    F, PT, PA = c.fault_fixed_ns, c.pt_alloc_ns, c.page_alloc_ns
    WL, WR, LM = c.pte_write_local_ns, c.pte_write_remote_ns, c.local_mem_ns
    if not (t.is_integer() and all(float(x).is_integer()
                                   for x in (F, PT, PA, WL, WR, LM))):
        return False  # n*c would not be bit-equal to n sequential adds
    k = int(g.size)
    # per-access charge: fault + page alloc + PTE write(s) + data access;
    # accesses after the first also pay a failed local walk (LM) because the
    # first fault has created the table by then.
    if policy is Policy.LINUX:
        owner, pt_allocs, wr = node, 1, 0
        per = F + PA + WL + LM
    elif policy is Policy.MITOSIS:
        owner, pt_allocs, wr = node, nn, k * (nn - 1)
        per = F + PA + WL + (nn - 1) * WR + LM
    else:  # NUMAPTE: table owner comes from the VMA (I1)
        owner = vma.owner
        if owner == node:
            pt_allocs, wr = 1, 0
            per = F + PA + WL + LM
        else:
            pt_allocs, wr = 2, k
            per = F + PA + WL + WR + LM
    total = pt_allocs * PT + k * per + (k - 1) * LM
    if t + total >= _MAX_EXACT:
        return False
    # ---- state mutation (bulk equivalents of the scalar fault path) ------
    table = store.create(ti, owner=owner)
    if policy is Policy.MITOSIS:
        for m in range(nn):
            if m not in table.copies:
                store.install_replica(table, m)
    elif policy is Policy.NUMAPTE and node not in table.copies:
        store.install_replica(table, node)
    perms = vma.perms
    frames = list(islice(sim._next_frame, k))
    idxs = (g & _IDX_MASK).tolist()
    # replicas share PTE objects: the simulator never mutates a PTE in
    # place (mprotect rebuilds entries via dataclasses.replace), so value
    # semantics are identical to the scalar path's per-replica copies.
    ptes = [PTE(f, node, perms) for f in frames]
    table.copies[node].update(zip(idxs, ptes))
    if policy is Policy.MITOSIS:
        for m, copy in table.copies.items():
            if m != node:
                copy.update(zip(idxs, ptes))
    elif policy is Policy.NUMAPTE and owner != node:
        table.copies[owner].update(zip(idxs, ptes))
    gl = g.tolist()
    vals = [(f, perms) for f in frames]
    ctx.proc.oracle.update(zip(gl, vals))
    sim._frame_nodes.update(zip(frames, repeat(node)))
    # FIFO TLB: k distinct fresh fills == evict the max(0, len+k-cap) oldest
    # entries, then append the fills in order.
    entries = ctx.tlb.entries
    cap = ctx.tlb.capacity
    n_evict = len(entries) + k - cap
    if n_evict <= 0:
        entries.update(zip(gl, vals))
    elif n_evict >= len(entries):
        skip = n_evict - len(entries)
        entries.clear()
        entries.update(zip(gl[skip:], vals[skip:]))
    else:
        for key in list(islice(iter(entries), n_evict)):
            del entries[key]
        entries.update(zip(gl, vals))
    ctr = sim.counters
    ctr.tlb_misses += k
    ctr.faults += k
    ctr.first_touches += k
    ctr.data_pages_alloc += k
    ctr.pt_pages_alloc += pt_allocs
    ctr.replica_writes_local += k
    ctr.replica_writes_remote += wr
    ctr.local_data_accesses += k
    thr.time_ns = t + total
    if frames_out is not None:
        frames_out.extend(frames)
    return True


# --------------------------------------------------------------------------
# general path
# --------------------------------------------------------------------------
def _general(ctx: _BatchContext, arr: np.ndarray,
             frames_out: Optional[List[int]]) -> None:
    """Dispatch a group to the vectorized three-pass engine when its
    exactness guard holds, else to the sequential interpreter loop."""
    if (frames_out is None and arr.size >= 64 and _vec_ok(ctx, arr.size)
            and _general_vec(ctx, arr)):
        return
    _general_seq(ctx, arr, frames_out)


def _vec_ok(ctx: _BatchContext, n: int) -> bool:
    """The vectorized path reorders float additions (hits are summed with
    NumPy while misses accumulate sequentially).  That is bit-equal to the
    scalar order only when every charged amount is integer-valued, so
    partial sums stay exact integers — and the running total never leaves
    the exactly-representable integer range."""
    sim = ctx.sim
    c = sim.cost
    t = ctx.thr.time_ns
    cap = ctx.tlb.capacity
    if cap <= 0 or len(ctx.tlb.entries) > cap:
        return False
    consts = (c.fault_fixed_ns, c.pt_alloc_ns, c.page_alloc_ns,
              c.pte_write_local_ns, c.pte_write_remote_ns,
              c.pte_copy_remote_ns, c.pte_copy_stream_ns, c.local_mem_ns)
    if not (all(float(x).is_integer() for x in consts)
            and all(float(x).is_integer() for x in ctx.remote_ns)):
        return False
    # worst-case per-access charge, derived from the actual cost model:
    # failed walk + fault + table create/replicate + page alloc + PTE
    # writes on every replica + copy + full 512-entry prefetch + data.
    nn = sim.topo.n_nodes
    per_access_max = (max(ctx.remote_ns) + c.fault_fixed_ns
                      + (nn + 1) * c.pt_alloc_ns + c.page_alloc_ns
                      + c.pte_write_local_ns + nn * c.pte_write_remote_ns
                      + c.pte_copy_remote_ns
                      + PTES_PER_TABLE * c.pte_copy_stream_ns
                      + max(ctx.remote_ns))
    return t.is_integer() and t + n * per_access_max < _MAX_EXACT


# indices into the shared counter accumulator used by _make_miss_protocol
(_WL, _WR, _FAULTS, _FTS, _DA, _PTALS, _RWL, _RWR, _PTC, _PF) = range(10)


def _make_miss_protocol(ctx: _BatchContext, acc: List[int],
                        tcell: List[Optional[float]]):
    """Build the per-miss walk/fault protocol closure shared by the
    sequential loop and the vectorized engine's pass 2.

    The returned ``miss_fn(vpn, t) -> (pte, t)`` performs exactly the
    scalar path's dict operations and float additions, in the same order:
    hardware walk against the local/canonical copy, failed-walk charge,
    then the per-policy fault protocol (first-touch allocation, replica
    install + sharer-mask update, eager MITOSIS coherence, NUMAPTE
    copy-on-demand with degree-d prefetch).  Event counts go into ``acc``
    (integer adds are order-free); modeled time threads through ``t``.  On
    a segfault the partial ``t`` (scalar charges up to the raise) is
    parked in ``tcell[0]`` before raising, so callers can flush the exact
    partial state the scalar loop would have left."""
    sim = ctx.sim
    node = ctx.node
    store = ctx.proc.store
    tables_get = store.tables.get
    oracle = ctx.proc.oracle
    fnodes = sim._frame_nodes
    nf = sim._next_frame
    c = sim.cost
    policy = sim.policy
    is_linux = policy is Policy.LINUX
    is_numapte = policy is Policy.NUMAPTE
    nn = sim.topo.n_nodes
    LM = ctx.local_mem
    REMOTE_NS = ctx.remote_ns
    FAIL_NS = ctx.fail_ns
    F, PT, PA = c.fault_fixed_ns, c.pt_alloc_ns, c.page_alloc_ns
    WLc, WRc = c.pte_write_local_ns, c.pte_write_remote_ns
    CPR, STREAM = c.pte_copy_remote_ns, c.pte_copy_stream_ns
    degree = sim.prefetch_degree
    want = 1 << degree
    half = want >> 1
    vma_at = ctx.vma_at

    def miss_fn(vpn: int, t: float):
        ti = vpn >> LEAF_SHIFT
        idx = vpn & _IDX_MASK
        tbl = tables_get(ti)
        pte = None
        if tbl is not None:                     # ---- hardware walk ----
            if is_linux:
                canon = tbl.owner
                pte = tbl.copies[canon].get(idx)
                if pte is not None:
                    if canon == node:
                        acc[_WL] += 1
                        t += LM
                    else:
                        acc[_WR] += 1
                        t += REMOTE_NS[canon]
                else:
                    t += FAIL_NS[canon]         # failed walk
            else:
                copy = tbl.copies.get(node)
                pte = copy.get(idx) if copy is not None else None
                if pte is not None:
                    acc[_WL] += 1
                    t += LM
                else:
                    t += LM                     # failed local walk
        if pte is not None:
            return pte, t
        # ---------------- page fault ----------------
        acc[_FAULTS] += 1
        t += F
        vma = vma_at(vpn)
        if vma is None:
            tcell[0] = t
            from .sim import SegfaultError
            raise SegfaultError(f"vpn {vpn} not mapped")
        perms = vma.perms
        if is_linux:
            if tbl is None:
                tbl = store.create(ti, owner=node)
                acc[_PTALS] += 1
                t += PT
            canon = tbl.owner
            ccopy = tbl.copies[canon]
            pte = ccopy.get(idx)
            if pte is None:
                frame = next(nf)
                acc[_FTS] += 1
                acc[_DA] += 1
                t += PA
                pte = PTE(frame, node, perms)
                ccopy[idx] = pte
                if canon == node:
                    acc[_RWL] += 1
                    t += WLc
                else:
                    acc[_RWR] += 1
                    t += WRc
                oracle[vpn] = (frame, perms)
                fnodes[frame] = node
        elif is_numapte:
            if tbl is None:
                tbl = store.create(ti, owner=vma.owner)
                acc[_PTALS] += 1
                t += PT
            if node not in tbl.copies:
                store.install_replica(tbl, node)
                acc[_PTALS] += 1
                t += PT
            owner = tbl.owner
            ocopy = tbl.copies[owner]
            opte = ocopy.get(idx)
            lcopy = tbl.copies[node]
            if opte is None:
                # never touched anywhere: create (owner gets it too, I1)
                frame = next(nf)
                acc[_FTS] += 1
                acc[_DA] += 1
                t += PA
                pte = PTE(frame, node, perms)
                lcopy[idx] = pte
                acc[_RWL] += 1
                t += WLc
                oracle[vpn] = (frame, perms)
                fnodes[frame] = node
                if owner != node:
                    ocopy[idx] = PTE(frame, node, perms)
                    acc[_RWR] += 1
                    t += WRc
            else:
                # owner has it: copy on demand + degree-d prefetch
                if node != owner:
                    t += CPR
                acc[_PTC] += 1
                pte = PTE(opte.frame, opte.frame_node, opte.perms)
                lcopy[idx] = pte
                if degree > 0 and node != owner:
                    base = ti << LEAF_SHIFT
                    lo = vma.start_vpn
                    if base > lo:
                        lo = base
                    v0 = vpn - half
                    if v0 > lo:
                        lo = v0
                    hi = vma.end_vpn
                    top = base + PTES_PER_TABLE
                    if top < hi:
                        hi = top
                    if lo + want < hi:
                        hi = lo + want
                    v0 = hi - want
                    if v0 > lo:
                        lo = v0
                    fetched = 0
                    for v in range(lo, hi):
                        ii = v & _IDX_MASK
                        if v == vpn or ii in lcopy:
                            continue
                        src = ocopy.get(ii)
                        if src is not None:
                            lcopy[ii] = PTE(src.frame, src.frame_node,
                                            src.perms)
                            fetched += 1
                    acc[_PF] += fetched
                    t += fetched * STREAM
        else:  # MITOSIS
            if tbl is None:
                tbl = store.create(ti, owner=node)
                acc[_PTALS] += 1
                t += PT
                for m in range(nn):
                    if m not in tbl.copies:
                        store.install_replica(tbl, m)
                        acc[_PTALS] += 1
                        t += PT
            mcopy = tbl.copies[node]
            pte = mcopy.get(idx)
            if pte is None:
                frame = next(nf)
                acc[_FTS] += 1
                acc[_DA] += 1
                t += PA
                pte = PTE(frame, node, perms)
                mcopy[idx] = pte
                acc[_RWL] += 1
                t += WLc
                oracle[vpn] = (frame, perms)
                fnodes[frame] = node
                for m, cp in tbl.copies.items():  # eager coherence
                    if m == node:
                        continue
                    cp[idx] = PTE(frame, node, perms)
                    acc[_RWR] += 1
                    t += WRc
        return pte, t

    return miss_fn


def _flush_acc(sim, acc: List[int], n_hits: int, n_miss: int,
               ld: int, rd: int) -> None:
    ctr = sim.counters
    ctr.tlb_hits += n_hits
    ctr.tlb_misses += n_miss
    ctr.walks_local += acc[_WL]
    ctr.walks_remote += acc[_WR]
    ctr.faults += acc[_FAULTS]
    ctr.first_touches += acc[_FTS]
    ctr.pte_copies += acc[_PTC]
    ctr.pte_prefetched += acc[_PF]
    ctr.replica_writes_local += acc[_RWL]
    ctr.replica_writes_remote += acc[_RWR]
    ctr.pt_pages_alloc += acc[_PTALS]
    ctr.data_pages_alloc += acc[_DA]
    ctr.local_data_accesses += ld
    ctr.remote_data_accesses += rd


def _general_vec(ctx: _BatchContext, arr: np.ndarray) -> bool:
    """Three passes: (0) per-unique-vpn resolution of the data-node charge
    and the *batch-start walk state* — both static for a whole batch,
    because frames never move mid-batch, in-batch first-touches are always
    local, and in-batch events only ever ADD PTEs (fault/prefetch installs
    never modify or remove an existing entry); (1) a minimal FIFO TLB
    simulation that extracts only the ordered miss list (an entry filled at
    fill-number f is live while f >= fills-so-far - capacity); (2) the
    shared miss protocol over only the misses whose PTE was absent at
    batch start — initially-present misses are walk hits with a
    precomputed charge and fill value.  Hits, walk hits and per-access
    data charges are accounted with NumPy sums, exact under the
    ``_vec_ok`` guard.  Returns False (state untouched) when a potential
    segfault demands the sequential loop's partial-state semantics."""
    sim = ctx.sim
    thr, node = ctx.thr, ctx.node
    entries = ctx.tlb.entries
    cap = ctx.tlb.capacity
    tables_get = ctx.proc.store.tables.get
    oget = ctx.proc.oracle.get
    fget = sim._frame_nodes.get
    is_linux = sim.policy is Policy.LINUX
    LM = ctx.local_mem
    REMOTE_NS = ctx.remote_ns
    n = int(arr.size)

    # ---- pass 0: per-unique resolution (uniq is sorted, so table-level
    # state is carried across consecutive vpns of the same leaf table) ----
    uniq, inv = np.unique(arr, return_inverse=True)
    u_list = uniq.tolist()
    n_u = len(u_list)
    dn_l = [node] * n_u
    present_l = [False] * n_u
    frame_l = [0] * n_u
    perms_l = [0] * n_u
    wlocal_l = [True] * n_u if is_linux else None
    wchg_l = [LM] * n_u if is_linux else None
    unmapped: List[int] = []
    cur_ti = -1
    cur_copy: Optional[dict] = None
    cur_local = True
    cur_chg = LM
    for k, v in enumerate(u_list):
        ti = v >> LEAF_SHIFT
        if ti != cur_ti:
            cur_ti = ti
            tbl = tables_get(ti)
            if tbl is None:
                cur_copy = None
            elif is_linux:
                canon = tbl.owner
                cur_copy = tbl.copies[canon]
                cur_local = canon == node
                cur_chg = REMOTE_NS[canon]
            else:
                cur_copy = tbl.copies.get(node)
        pte = cur_copy.get(v & _IDX_MASK) if cur_copy is not None else None
        if pte is not None:
            # a present replica PTE carries the oracle frame (I3), so the
            # data-node lookup can skip the oracle entirely.
            present_l[k] = True
            frame_l[k] = pte.frame
            perms_l[k] = pte.perms
            dn_l[k] = fget(pte.frame, node)
            if is_linux:
                wlocal_l[k] = cur_local
                wchg_l[k] = cur_chg
        else:
            oe = oget(v)
            if oe is None:
                unmapped.append(v)  # faulted in-batch => first-touch local
            else:
                dn_l[k] = fget(oe[0], node)
    for v in unmapped:
        if ctx.vma_at(v) is None:
            return False             # mid-batch segfault: sequential path
    dn_arr = np.asarray(dn_l, dtype=np.int64)
    charge_tab = np.asarray(REMOTE_NS, dtype=np.float64)  # [node] == LM
    ld = int(np.count_nonzero((dn_arr == node)[inv]))
    data_total = float(charge_tab[dn_arr][inv].sum())

    # ---- pass 1: FIFO TLB simulation -> ordered miss list (the scan
    # kernel: one launch on the card over pass 0's ids, or with
    # REPRO_FIFO_MISS_BACKEND=numpy the dict loop) ----
    len0 = len(entries)
    miss: List[int] = arr[fifo_miss(arr, entries, cap,
                                    dense=(uniq, inv))].tolist()
    n_miss = len(miss)
    nfill = len0 + n_miss

    # ---- vectorized walk hits + shared protocol over absent misses ----
    t = 0.0
    acc = [0] * 10
    if n_miss:
        marr = np.asarray(miss, dtype=np.int64)
        pos = np.searchsorted(uniq, marr)
        pre = np.asarray(present_l, dtype=bool)[pos]
        n_pre = int(np.count_nonzero(pre))
        if n_pre:
            if is_linux:
                acc[_WL] = int(np.count_nonzero(
                    np.asarray(wlocal_l, dtype=bool)[pos] & pre))
                acc[_WR] = n_pre - acc[_WL]
                t += float(
                    np.asarray(wchg_l, dtype=np.float64)[pos][pre].sum())
            else:
                # MITOSIS/NUMAPTE hardware walks are always local; n*LM is
                # exact under the _vec_ok integrality guard.
                acc[_WL] = n_pre
                t += n_pre * LM
        fill_frames = np.asarray(frame_l, dtype=np.int64)[pos]
        fill_perms = np.asarray(perms_l, dtype=np.int64)[pos]
        seq_positions = np.flatnonzero(~pre).tolist()
    else:
        fill_frames = fill_perms = np.empty(0, dtype=np.int64)
        seq_positions = []
    if seq_positions:
        miss_fn = _make_miss_protocol(ctx, acc, [None])
        for j in seq_positions:
            pte, t = miss_fn(miss[j], t)
            fill_frames[j] = pte.frame
            fill_perms[j] = pte.perms

    # ---- final TLB state: trim dead entries, append live fills.  Only the
    # last `cap` fills can be live, so the rebuilt tail stays small. ----
    cut = nfill - cap
    skip = 0 if cut <= len0 else cut - len0
    live_vals = zip(fill_frames[skip:].tolist(), fill_perms[skip:].tolist())
    if cut <= 0:
        entries.update(zip(miss, live_vals))
    elif cut >= len0:
        entries.clear()
        entries.update(zip(miss[skip:], live_vals))
    else:
        for key in list(islice(iter(entries), cut)):
            del entries[key]
        entries.update(zip(miss, live_vals))

    _flush_acc(sim, acc, n - n_miss, n_miss, ld, n - ld)
    thr.time_ns = thr.time_ns + t + data_total
    return True


# --------------------------------------------------------------------------
# general path: exact sequential interpreter loop
# --------------------------------------------------------------------------
def _general_seq(ctx: _BatchContext, arr: np.ndarray,
                 frames_out: Optional[List[int]]) -> None:
    sim = ctx.sim
    thr, node = ctx.thr, ctx.node
    entries = ctx.tlb.entries
    cap = ctx.tlb.capacity
    oget = ctx.proc.oracle.get
    fget = sim._frame_nodes.get
    LM = ctx.local_mem
    REMOTE_NS = ctx.remote_ns
    rec = frames_out.append if frames_out is not None else None
    acc = [0] * 10
    tcell: List[Optional[float]] = [None]
    miss_fn = _make_miss_protocol(ctx, acc, tcell)
    t = thr.time_ns
    hits = misses = ld = rd = 0
    try:
        for vpn in arr.tolist():
            e = entries.get(vpn)
            if e is not None:                       # ---- TLB hit ----
                hits += 1
                oe = oget(vpn)
                if oe is not None:
                    dn = fget(oe[0], node)
                    if dn == node:
                        ld += 1
                        t += LM
                    else:
                        rd += 1
                        t += REMOTE_NS[dn]
                if rec is not None:
                    rec(e[0])
                continue
            misses += 1
            pte, t = miss_fn(vpn, t)
            # -------- TLB fill + data-access accounting --------
            frame = pte.frame
            if len(entries) >= cap:
                del entries[next(iter(entries))]
            entries[vpn] = (frame, pte.perms)
            oe = oget(vpn)
            if oe is not None:
                dn = fget(oe[0], node)
                if dn == node:
                    ld += 1
                    t += LM
                else:
                    rd += 1
                    t += REMOTE_NS[dn]
            if rec is not None:
                rec(frame)
    finally:
        # single flush; on SegfaultError the protocol closure parks its
        # partial time in tcell, so this leaves exactly the partial state
        # the scalar loop would have accumulated before raising.
        if tcell[0] is not None:
            t = tcell[0]
        _flush_acc(sim, acc, hits, misses, ld, rd)
        thr.time_ns = t
