"""Vectorized contention settlement: whole-target-mask array math per round.

The scalar contention models (``repro_torch.core.shootdown``) visit targets one
CPU at a time in pure Python: per round, a sorted loop computes each
target's IPI arrival, queue delay, busy-horizon advance, mid-shootdown
ack-horizon extension and responder stretch, and the engines then loop
again over the targets to charge every resident thread.  At the paper's
testbed scale — 288 hardware threads, ~280 resident spinners, every
unfiltered Linux round fanning out to every socket (HTC, arXiv:1701.07517,
shows why full-fan-out rounds dominate) — that is hundreds of Python
dict/float operations per 4KB munmap, which is what kept the Fig 1
calibration ramp away from the absolute 280-spinner regime.

This module computes the identical settlement as array operations over
the whole target mask:

  * busy horizons, initiator ack windows, receive-queue delays, responder
    stretches and coalescing merges are NumPy gathers/scatters and
    element-wise arithmetic — every per-element IEEE operation is exactly
    the op the scalar loop performs on that element, so per-CPU state and
    per-thread charges are bit-identical by construction;
  * the only order-sensitive reductions — the ``ipi_queue_delay_ns`` /
    ``responder_delay_ns`` sums, which the scalar loop accumulates in
    sorted-CPU order — use ``np.sum`` only under the integer-exactness
    guard proven in ``repro_torch.core.batch`` / ``mm_batch`` (every addend an
    integer-valued float, total below 2^52: any summation order is
    exact), and otherwise fall back to a sequential Python add loop in
    the same sorted order as the scalar reference.

Two integration levels ship:

  * :func:`settle_round` — drop-in replacement for ``model.settle`` used
    by ``NumaSim._shootdown``: NumPy math over the round, the model's
    ``busy_until`` / ``initiator_until`` dicts stay the authoritative
    (and always-current) state, and the returned
    :class:`~repro_torch.core.shootdown.RoundSettlement` is bit-identical to
    the scalar loop's.
  * :class:`BatchSettlement` — the batched mm-op engine's settlement
    state for one ``apply_mm_ops(..., concurrency="overlap")`` batch:
    busy horizons, inflight windows, *and* per-thread modeled times /
    IPI counts live in dense arrays for the batch's duration (loaded
    from, and flushed back to, the model dicts and ``Thread`` objects),
    so a full round — settlement plus two-sided responder charges —
    is a handful of vector ops instead of two O(targets) Python loops.

Only the stock :class:`QueueContention` and :class:`CoalescingContention`
models are vector-eligible (``supports_vector``): a custom subclass may
override ``settle`` arbitrarily, so it settles through its own scalar
loop (``settle="sequential"``).  ``resolve_settle`` maps the public
``settle`` knob (``"auto"`` / ``"vector"`` / ``"sequential"``) onto the
engine actually used; the engines report that choice (and the rare
mid-batch abandonment, ``"mixed"``) so benchmark rows can record which
settlement engine produced them.
"""
from __future__ import annotations

from typing import FrozenSet, Tuple

import numpy as np

from .shootdown import (CoalescingContention, QueueContention,
                        RoundSettlement)

__all__ = ["SETTLE_MODES", "BatchSettlement", "resolve_settle",
           "settle_round", "supports_vector"]

#: settlement-engine selectors of apply_mm_ops / NumaSim (single source of
#: truth — the benchmark layer derives its choices from this).
SETTLE_MODES = ("auto", "vector", "sequential")

#: beyond this magnitude float addition of integers can round; fall back.
_MAX_EXACT = float(1 << 52)

_NO_CPUS: FrozenSet[int] = frozenset()
_ZERO = RoundSettlement()


def supports_vector(model) -> bool:
    """Only the stock models are vector-eligible: a subclass may override
    ``settle``, and the vectorized math must mirror a known loop."""
    return type(model) in (QueueContention, CoalescingContention)


def resolve_settle(settle: str, model) -> str:
    """Map the public ``settle`` knob onto the engine actually used."""
    if settle not in SETTLE_MODES:
        raise ValueError(f"unknown settle {settle!r}; pick from "
                         f"{SETTLE_MODES}")
    if settle == "sequential":
        return "sequential"
    ok = model is not None and supports_vector(model)
    if settle == "vector" and not ok:
        raise ValueError(
            "settle='vector' requires a stock QueueContention/"
            f"CoalescingContention model, got "
            f"{type(model).__name__ if model is not None else None}")
    return "vector" if ok else "sequential"


def _ordered_sum(vals: np.ndarray) -> float:
    """Sum positive addends exactly as the scalar loop does.

    ``vals`` is already in sorted-CPU order (the scalar visit order).
    When every addend is an integer-valued float and the total stays
    below 2^52, any summation order is exact, so ``np.sum`` is
    bit-identical to the sequential adds; otherwise replay the adds
    sequentially in the same order."""
    if not vals.size:
        return 0.0
    s = float(vals.sum())
    if s < _MAX_EXACT and not bool(np.any(vals != np.floor(vals))):
        return s
    t = 0.0
    for v in vals.tolist():
        t += v
    return t


def _settle_core(t_start: float, arrival: np.ndarray, free: np.ndarray,
                 fin: np.ndarray, handler: float, merge: bool):
    """The pure array math of one round (shared by both levels).

    Mirrors ``QueueContention.settle``'s per-target loop element-wise:
    every add/compare below is the exact IEEE operation the scalar loop
    performs on that element.  Returns
    ``(qmask, delay, worst, queued, extras, finm, resp, busy_new)``
    where ``busy_new`` covers all targets (queue model) or only the
    non-merged ones (coalescing model — callers scatter with ``~qmask``).
    """
    qmask = free > arrival
    delay = np.where(qmask, free - arrival, 0.0)
    worst = float(delay.max()) if delay.size else 0.0
    queued = _ordered_sum(delay[qmask])
    if merge:
        # coalesce into the pending handler: no new occupancy, no
        # responder charge, and no mid-shootdown check for merged cpus
        nonm = ~qmask
        busy_new = arrival[nonm] + handler
        finm = nonm & (fin > arrival)
        extras = np.where(finm, handler, 0.0)
    else:
        begin = np.where(qmask, free, arrival)
        busy_new = begin + handler
        finm = fin > arrival
        extras = delay.copy()
        extras[finm] += handler
    resp = _ordered_sum(extras[extras > 0.0])
    return qmask, delay, worst, queued, extras, finm, resp, busy_new


def settle_round(model, t_start: float, my_cpu: int, targets, node_of,
                 cost, *, hw_per_node: int = 0) -> RoundSettlement:
    """Vectorized ``model.settle`` for the scalar simulator path.

    The model's dicts remain the authoritative state (loaded per round,
    written back in bulk), so direct syscalls, batches and test
    introspection can interleave freely.  ``hw_per_node`` short-circuits
    ``node_of`` to the topology's floor-division when the caller knows it
    (both engines do)."""
    tlist = sorted(targets)
    n = len(tlist)
    tarr = np.asarray(tlist, dtype=np.int64)
    my_node = node_of(my_cpu)
    if hw_per_node:
        larr = (tarr // hw_per_node) == my_node
    else:
        larr = np.fromiter((node_of(c) == my_node for c in tlist),
                           np.bool_, n)
    n_local = int(larr.sum())
    n_remote = n - n_local
    busy = model.busy_until
    inflight = model.initiator_until
    handler = model.handler_ns
    merge = model.merge_pending
    if t_start > model.clock:
        model.clock = t_start
    else:
        t_start = model.clock
    arrival = np.where(larr, t_start + cost.ipi_dispatch_local_ns,
                       t_start + cost.ipi_dispatch_remote_ns)
    free = np.fromiter((busy.get(c, 0.0) for c in tlist), np.float64, n)
    # -1.0 is a safe "absent" sentinel: real ack windows are never
    # negative (thread clocks start at 0 and dispatch costs are >= 0).
    fin = np.fromiter((inflight.get(c, -1.0) for c in tlist),
                      np.float64, n)
    qmask, delay, worst, queued, extras, finm, resp, busy_new = \
        _settle_core(t_start, arrival, free, fin, handler, merge)
    if merge:
        busy.update(zip(tarr[~qmask].tolist(), busy_new.tolist()))
        merged_cpus = (frozenset(tarr[qmask].tolist()) if bool(qmask.any())
                       else _NO_CPUS)
    else:
        busy.update(zip(tlist, busy_new.tolist()))
        merged_cpus = _NO_CPUS
    if bool(finm.any()):
        inflight.update(zip(tarr[finm].tolist(),
                            (fin[finm] + handler).tolist()))
    inflight[my_cpu] = (t_start + cost.shootdown_cost_ns(n_local, n_remote)
                        + worst)
    emask = extras > 0.0
    if queued == 0.0 and not bool(emask.any()) and not merged_cpus:
        return _ZERO
    stretch = dict(zip(tarr[emask].tolist(), extras[emask].tolist()))
    return RoundSettlement(extra_wait_ns=worst, queued_ns=queued,
                           contended=queued > 0.0,
                           target_stretch=stretch,
                           responder_delay_ns=resp,
                           coalesced_cpus=merged_cpus)


class BatchSettlement:
    """Array-state settlement for one batched-mm-op overlap batch.

    Busy horizons, inflight ack windows, per-thread working times and
    IPI-receive counts live in dense arrays for the batch's duration —
    loaded from the model's dicts / the simulator's ``Thread`` objects
    at construction and flushed back by the engine's ``_finish`` (or
    immediately on abandonment).  ``settle_and_charge`` performs one
    full round: the settlement math *and* the two-sided responder
    charges (handler occupancy then stretch, as two separate adds per
    thread — the exact ``charge_responders`` sequence), returning only
    the initiator-side results the engine needs.

    A round whose start time is not finite (a pathological cost model
    could produce one) refuses to settle — ``settle_and_charge`` returns
    ``None`` and the engine abandons the vector state (flushes it) and
    falls back to the scalar model loops for the rest of the batch,
    reporting ``settle_engine="mixed"`` so downstream determinism checks
    never silently compare mixed-engine artifacts.
    """

    def __init__(self, sim, model):
        if not supports_vector(model):       # engine guards this already
            raise ValueError(f"unsupported model {type(model).__name__}")
        self.sim = sim
        self.model = model
        self.merge = model.merge_pending
        self.handler = float(model.handler_ns)
        n_cpus = sim.topo.total_hw_threads
        self.busy = np.zeros(n_cpus)
        self.busy_touched = np.zeros(n_cpus, np.bool_)
        self.inflight = np.full(n_cpus, -1.0)
        self.inflight_touched = np.zeros(n_cpus, np.bool_)
        for cpu, v in model.busy_until.items():
            self.busy[cpu] = v
            self.busy_touched[cpu] = True
        for cpu, v in model.initiator_until.items():
            self.inflight[cpu] = v
            self.inflight_touched[cpu] = True
        self.clock = model.clock
        # per-thread mirrors (tids are dense: spawn_thread counts from 0)
        n_t = (max(sim.threads) + 1) if sim.threads else 0
        self.times = np.zeros(n_t)
        self.ipis = np.zeros(n_t, np.int64)
        for tid, thr in sim.threads.items():
            self.times[tid] = thr.time_ns
        self.rebuild_cpu_map()

    def rebuild_cpu_map(self) -> None:
        """cpu -> resident tid (-1 none, -2 several; several share via
        ``_multi``).  Rebuilt by the engine after a migrate op."""
        cpu2tid = np.full(len(self.busy), -1, np.int64)
        multi = {}
        for cpu, thrs in self.sim._cpu_threads.items():
            if len(thrs) == 1:
                cpu2tid[cpu] = thrs[0].tid
            elif thrs:
                cpu2tid[cpu] = -2
                multi[cpu] = thrs
        self.cpu2tid = cpu2tid
        self._multi = multi

    def settle_and_charge(self, t_start: float, my_cpu: int,
                          tarr: np.ndarray, larr: np.ndarray,
                          n_local: int, n_remote: int, cost
                          ) -> Tuple[float, float, bool, int, float] | None:
        """Settle one round and apply its responder charges.

        Returns ``(extra_wait_ns, queued_ns, contended, n_coalesced,
        responder_delay_ns)`` — the initiator-side view the engine folds
        into counters — or ``None`` to abandon vector mode."""
        if not np.isfinite(t_start):
            return None
        if t_start > self.clock:
            self.clock = t_start
        else:
            t_start = self.clock
        arrival = np.where(larr, t_start + cost.ipi_dispatch_local_ns,
                           t_start + cost.ipi_dispatch_remote_ns)
        free = self.busy[tarr]
        fin = self.inflight[tarr]
        qmask, delay, worst, queued, extras, finm, resp, busy_new = \
            _settle_core(t_start, arrival, free, fin, self.handler,
                         self.merge)
        if self.merge:
            merged = qmask
            nonm = ~qmask
            idx = tarr[nonm]
            self.busy[idx] = busy_new
            self.busy_touched[idx] = True
            n_coal = int(qmask.sum())
        else:
            merged = None
            self.busy[tarr] = busy_new
            self.busy_touched[tarr] = True
            n_coal = 0
        if bool(finm.any()):
            idx = tarr[finm]
            self.inflight[idx] = fin[finm] + self.handler
            self.inflight_touched[idx] = True
        self.inflight[my_cpu] = (t_start
                                 + cost.shootdown_cost_ns(n_local, n_remote)
                                 + worst)
        self.inflight_touched[my_cpu] = True
        # ---- two-sided responder charges (charge_responders, vectorized):
        # handler occupancy then stretch, as two separate per-thread adds;
        # coalesced cpus skip the handler; every delivery counts an IPI.
        tids = self.cpu2tid[tarr]
        one = tids >= 0
        pay = one if merged is None else (one & ~merged)
        pt = tids[pay]
        if pt.size:
            self.times[pt] += self.handler
        em = one & (extras > 0.0)
        et = tids[em]
        if et.size:
            self.times[et] += extras[em]
        ot = tids[one]
        if ot.size:
            self.ipis[ot] += 1
        if bool((tids == -2).any()):
            for pos in np.flatnonzero(tids == -2).tolist():
                cpu = int(tarr[pos])
                pay_handler = merged is None or not bool(merged[pos])
                extra = float(extras[pos])
                for thr in self._multi[cpu]:
                    t = float(self.times[thr.tid])
                    if pay_handler:
                        t += self.handler
                    if extra:
                        t += extra
                    self.times[thr.tid] = t
                    self.ipis[thr.tid] += 1
        return worst, queued, queued > 0.0, n_coal, resp

    def settle_window(self, t_starts: np.ndarray, my_cpu: int,
                      tarr: np.ndarray, larr: np.ndarray,
                      n_local: int, n_remote: int, cost) -> bool:
        """Settle a whole *window* of W same-initiator, same-target-mask
        rounds in one engine call (the trace engine's windowed path).

        ``t_starts`` are the W round-start times the caller computed
        assuming every round settles clean (zero queue delay, zero
        stretch, no coalescing merge, no mid-shootdown ack extension).
        This method *verifies* that assumption against the live horizons
        — per element, the exact IEEE comparisons the W sequential
        ``settle_and_charge`` calls would perform — and only if every
        round provably settles clean does it apply the whole window's
        state updates at once:

          * ``busy[targets]`` ends at the last round's ``arrival +
            handler`` (each clean round overwrites the previous one's);
          * ``inflight[my_cpu]`` ends at the last round's ack window;
          * the clock advances to ``t_starts[-1]``;
          * every resident target thread is charged W handler occupancies
            (one vectorized multiply under the integer-exactness guard,
            else W sequential vector adds — bit-equal either way) and W
            IPI deliveries.

        Returns ``True`` on success (every round's initiator-side view is
        all-zero: no extra wait, no queueing, no coalescing, no responder
        delay) or ``False`` if any guard fails — the caller then replays
        the window round-by-round through ``settle_and_charge``.
        """
        W = len(t_starts)
        if W < 2 or not tarr.size:
            return False
        t_starts = np.asarray(t_starts, dtype=np.float64)
        if not np.isfinite(t_starts).all():
            return False
        # clock guard: every round must leave t_start unraised (t_k >= the
        # evolving clock, which under cleanness is just the previous t_k).
        if t_starts[0] < self.clock or bool((np.diff(t_starts) < 0).any()):
            return False
        disp = np.where(larr, cost.ipi_dispatch_local_ns,
                        cost.ipi_dispatch_remote_ns)
        # (W, n) arrivals: element [k, i] is the one IEEE add round k
        # performs for target i.
        arrival = t_starts[:, None] + disp[None, :]
        # queue guard: round 0 against the live horizons; round k>0
        # against round k-1's busy_new = arrival + handler (my_cpu is
        # never a target, so nothing else touches these horizons).
        if bool((self.busy[tarr] > arrival[0]).any()):
            return False
        if bool(((arrival[:-1] + self.handler) > arrival[1:]).any()):
            return False
        # mid-shootdown guard: no target's in-flight ack window may
        # extend (fin > arrival in any round); clean rounds never update
        # inflight[targets], so the live values cover all W rounds.
        if bool((self.inflight[tarr][None, :] > arrival).any()):
            return False
        # ---- every round is provably clean: apply the window at once.
        last = arrival[-1] + self.handler
        self.busy[tarr] = last
        self.busy_touched[tarr] = True
        self.inflight[my_cpu] = (float(t_starts[-1])
                                 + cost.shootdown_cost_ns(n_local, n_remote))
        self.inflight_touched[my_cpu] = True
        self.clock = float(t_starts[-1])
        tids = self.cpu2tid[tarr]
        one = tids >= 0
        pt = tids[one]
        handler = self.handler
        multi = bool((tids == -2).any())
        mtids = []
        if multi:
            for pos in np.flatnonzero(tids == -2).tolist():
                mtids.extend(thr.tid for thr in self._multi[int(tarr[pos])])
        allt = np.concatenate([pt, np.asarray(mtids, np.int64)]) \
            if mtids else pt
        if allt.size:
            times = self.times
            cur = times[allt]
            total = W * handler
            if (handler.is_integer()
                    and not bool(np.any(cur != np.floor(cur)))
                    and float(cur.max()) + total < _MAX_EXACT):
                times[allt] = cur + total
            else:
                for _ in range(W):   # exact sequential fallback, per round
                    times[allt] += handler
            self.ipis[allt] += W
        return True

    def flush(self) -> None:
        """Write the array state back to the model's dicts (exactly the
        keys the scalar loops would have inserted) and its clock.  The
        engine flushes thread times / IPI counts itself."""
        bu = self.model.busy_until
        for cpu in np.flatnonzero(self.busy_touched).tolist():
            bu[cpu] = float(self.busy[cpu])
        iu = self.model.initiator_until
        for cpu in np.flatnonzero(self.inflight_touched).tolist():
            iu[cpu] = float(self.inflight[cpu])
        self.model.clock = self.clock
