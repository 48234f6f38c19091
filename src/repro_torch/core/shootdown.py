"""Contention-aware TLB-shootdown model: overlapping IPI rounds, two-sided.

The scalar simulator (and the batched mm-op engine) settle every shootdown as
if it ran alone: the initiator pays dispatch + one ack wait, each target
thread pays a fixed interrupt-handler cost, and the next shootdown starts
from a quiet system.  That is the right reference semantics, but it cannot
reproduce the paper's headline NUMA result — munmap/mprotect degrading up
to 40x — because that cliff comes from *concurrent* shootdowns contending
for interrupt delivery on **both** sides of the round (HTC,
arXiv:1701.07517, models exactly this initiator/responder overlap in
hardware):

  * **initiator side** — when many threads mutate the address space at
    once, their IPI rounds overlap, each target CPU serializes the
    handlers, and every initiator's synchronous ack wait stretches by the
    receive-queue delay of its slowest target;
  * **responder side** — a target thread's useful work is preempted by the
    queued invalidation interrupts: its modeled clock stretches by its
    CPU's receive-queue delay (not just the flat handler cost), and a
    thread that is *itself mid-shootdown* when an IPI lands (a
    responder-side initiator) has its in-flight ack horizon extended — it
    must service the interrupt before it can resume spinning on its own
    acks.

numaPTE's sharer filter matters precisely because it keeps CPUs *out* of
that queue, on both sides.

This module is the pluggable settlement layer: :class:`NumaSim` (and the
batched mm-op engine via ``apply_mm_ops(..., concurrency="overlap")``)
hand every round to a :class:`ContentionModel`, which owns the
discrete-event state — per-CPU interrupt-handler busy horizons and
per-CPU in-flight initiator (ack-wait) windows — and returns what the
round costs *beyond* the classic charges:

  * ``extra_wait_ns``      — added to the initiating thread on top of the
    classic dispatch/ack charge: the slowest target's queue delay (the ack
    the initiator spins on cannot return before that handler has run).
  * ``queued_ns``          — the sum of all targets' receive-queue delays
    for this round (the ``ipi_queue_delay_ns`` counter).
  * ``contended``          — whether any target's handler was busy on
    arrival (the ``overlapping_rounds`` counter).
  * ``target_stretch``     — per-target-CPU responder stretch: extra ns
    charged to every thread on that CPU *on top of* the handler occupancy
    (its receive-queue delay, plus the ack-horizon extension when the CPU
    hosts a mid-shootdown initiator).  The sum is ``responder_delay_ns``
    (the counter of the same name).
  * ``coalesced_cpus``     — target CPUs whose invalidation merged into an
    already-pending handler (Linux's flush batching): the responder pays
    no new handler occupancy for them (the ``ipis_coalesced`` counter).

Four models ship:

  * :class:`NullContention` — the zero-delay model: every round settles to
    exactly zero extra cost, so an ``overlap``-mode run is byte-identical
    (counters, float-exact thread times, TLB order, sharer masks, VMA
    layout) to the sequential reference.  This is the differential anchor
    proven by ``tests/test_shootdown_contention.py``.
  * :class:`QueueContention` — one busy horizon per target CPU, advanced
    by a fixed handler occupancy per received IPI.  A round arriving at a
    busy CPU queues behind the in-flight handler(s); the initiator's wait
    stretches by the worst queue delay among its targets, and each
    responder is stretched by its own queue delay (plus the mid-shootdown
    ack-horizon extension).
  * :class:`CoalescingContention` — same discrete-event state, but an
    invalidation that arrives while a handler is still pending on the
    target CPU *merges* into that handler (one occupancy serves all
    merged invalidations, as Linux's batched flushes do; "Skip TLB
    flushes for reused pages", arXiv:2409.10946, quantifies how much this
    coalescing matters).  The initiator still waits for the merged
    handler to finish; the responder pays nothing extra.
  * :class:`HardwareCoherence` — the IPI-free upper bound (HATRIC): no
    dispatch, no handler, no ack wait; each target pays only a per-line
    invalidation cost for the stale entries its TLB actually holds,
    scaled by NUMA hop distance.  Differencing it against a coalescing
    run on the identical trace decomposes the Fig 1 cliff into "IPI
    dispatch+ack" vs "flush work".

Determinism: targets are visited in sorted CPU order inside the models,
so float accumulation order (and therefore every modeled time and the
``ipi_queue_delay_ns`` / ``responder_delay_ns`` counters) is identical no
matter which engine — scalar syscalls or the batched mm-op engine —
drives the rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Iterable, Mapping, Optional

#: interrupt-handler occupancy per received IPI, charged to each target
#: thread and occupying the target CPU's handler.  Models that are
#: constructed with a custom ``handler_ns`` override this consistently on
#: both sides (CPU busy horizon *and* thread charge) — see
#: ``ContentionModel.handler_ns``.
IPI_RECEIVE_NS = 700.0

#: per-stale-TLB-entry invalidation cost under hardware TLB coherence: the
#: coherence fabric unicasts one invalidation message per cached
#: translation (HATRIC's Tomasulo-style per-line tracking), so the cost is
#: proportional to how many stale entries the target TLB actually holds —
#: not to the fan-out of a software IPI broadcast.
HW_LINE_INVALIDATE_NS = 40.0

#: additional per-line cost per NUMA hop between the initiating CPU's node
#: and the target TLB's node (the invalidation rides the same interconnect
#: as coherence traffic; see ``NumaTopology.hops``).
HW_HOP_NS = 20.0

_NO_CPUS: FrozenSet[int] = frozenset()


@dataclasses.dataclass(frozen=True)
class RoundSettlement:
    """What one IPI round costs beyond the classic (sequential) charges."""
    extra_wait_ns: float = 0.0   # initiator ack-wait stretch (slowest target)
    queued_ns: float = 0.0       # sum of per-target receive-queue delays
    contended: bool = False      # any target handler busy on IPI arrival
    #: cpu -> responder stretch beyond the handler occupancy (queue delay
    #: + mid-shootdown ack-horizon extension); only nonzero entries.
    target_stretch: Mapping[int, float] = \
        dataclasses.field(default_factory=dict)
    #: total responder stretch == sum(target_stretch.values()), summed in
    #: sorted-cpu order so both engines accumulate the identical float.
    responder_delay_ns: float = 0.0
    #: target cpus whose invalidation merged into a pending handler: the
    #: responder pays no handler occupancy (and no stretch) for them.
    coalesced_cpus: FrozenSet[int] = _NO_CPUS


_ZERO = RoundSettlement()


def charge_responders(s: RoundSettlement, handler: float, targets,
                      cpu_threads, read_time, write_time, *,
                      count_ipis: bool = True, asid=None) -> None:
    """Apply one settled round's responder charges to the target threads.

    Both engines — the scalar ``NumaSim._shootdown`` and the batched
    ``mm_batch._MMEngine._shootdown`` — call this with their own
    time accessors (``Thread.time_ns`` vs the engine's working-time
    dict), so the per-thread float sequence (handler occupancy, then the
    stretch, as two separate adds; coalesced CPUs skip the handler) is
    shared code and the scalar==batch parity is structural, not merely
    test-enforced.  ``ipis_received`` counts every delivery, merged or
    not.

    :class:`HardwareCoherence` rounds reuse this helper with
    ``count_ipis=False`` (no interrupt is delivered — the invalidation
    rides the coherence fabric) and ``asid`` set to the initiating
    process: a hardware invalidation stalls only threads whose TLB
    context it targets, never an unrelated tenant time-sharing the CPU.
    """
    stretch = s.target_stretch
    coalesced = s.coalesced_cpus
    for cpu in targets:
        pay_handler = cpu not in coalesced
        extra = stretch.get(cpu, 0.0)
        for thr in cpu_threads.get(cpu, ()):
            if asid is not None and thr.asid != asid:
                continue
            t = read_time(thr)
            if pay_handler:
                t += handler
            if extra:
                t += extra
            write_time(thr, t)
            if count_ipis:
                thr.ipis_received += 1


class ContentionModel:
    """Interface: settle one IPI round against the in-flight rounds.

    ``settle`` is called once per shootdown round that has at least one
    target CPU, *before* the classic initiator charge lands, with:

      * ``t_start``  — the initiating thread's modeled time at round start
        (after the syscall's PTE-update charges, before the shootdown
        charge), i.e. when the IPIs are dispatched;
      * ``my_cpu``   — the initiator's CPU id (its NUMA node — the
        dispatch latency class — derives via ``node_of``; the CPU itself
        keys the in-flight initiator window for responder-side
        settlement);
      * ``targets``  — the target CPU ids (each receives exactly one IPI;
        any iteration order — the model must not depend on it);
      * ``node_of``  — cpu id -> node id;
      * ``cost``     — the simulator's :class:`CostModel` (dispatch ns).

    ``handler_ns`` is the interrupt-handler occupancy the model assumes:
    the engines charge exactly this much to every (non-coalesced) target
    thread, so the CPU busy horizon and the thread charge can never
    silently disagree.
    """

    #: handler occupancy assumed by the model; engines charge target
    #: threads exactly this (keeps busy horizons and thread charges in
    #: agreement even for custom-``handler_ns`` models).
    handler_ns: float = IPI_RECEIVE_NS

    #: True for models that settle rounds with no IPIs at all (hardware
    #: TLB coherence): the engines take the invalidation-message path —
    #: zero dispatch, zero handler occupancy, zero ack wait — instead of
    #: calling ``settle``.  Software models leave this False.
    ipi_free: bool = False

    def settle(self, t_start: float, my_cpu: int, targets: Iterable[int],
               node_of: Callable[[int], int], cost) -> RoundSettlement:
        raise NotImplementedError

    def reset(self) -> None:
        """Forget all in-flight state (fresh quiet system)."""


class NullContention(ContentionModel):
    """Zero-delay model: rounds never contend.  ``overlap`` mode under this
    model is byte-identical to the sequential reference — the property the
    differential suite pins."""

    def settle(self, t_start, my_cpu, targets, node_of, cost
               ) -> RoundSettlement:
        return _ZERO

    def reset(self) -> None:
        pass


class QueueContention(ContentionModel):
    """Discrete-event receive queues: one busy horizon per target CPU.

    An IPI dispatched at ``t_start`` arrives at a target CPU after that
    target's dispatch latency (same-socket multicast vs cross-socket).  If
    the CPU's handler is still occupied by earlier rounds, the IPI queues;
    its handler runs back-to-back after the in-flight ones and occupies the
    CPU for ``handler_ns``.  The initiator's synchronous wait stretches by
    the largest queue delay among its targets (classic ack waits already
    cover the uncontended handler latency).

    Responder side (two-sided settlement): every queued target's threads
    are stretched by that CPU's queue delay — their useful work sits
    behind the serialized handlers.  A target CPU that hosts a
    *mid-shootdown initiator* (its own ack window, recorded per round in
    ``initiator_until``, still covers the IPI's arrival) additionally
    pays one handler occupancy of ack-horizon extension: the spinning
    initiator must service the interrupt before resuming its spin, and
    its in-flight window grows by the same amount (so later arrivals
    still see it mid-shootdown).  Both charges surface as
    ``target_stretch`` / ``responder_delay_ns``.

    The busy horizons only ever move forward, so settlement is O(targets)
    per round with no event heap, and a CPU's horizon is independent of
    every other CPU's — results do not depend on target visit order (the
    model still sorts, so float sums are reproducible bit-for-bit).
    Multiple initiator threads time-sharing one CPU share that CPU's
    in-flight window (last round wins) — a deliberate simplification.

    Round start times are carried on a monotone program-order event clock
    (``max`` of every round start seen so far): per-thread modeled clocks
    drift apart freely (the simulator has no global scheduler), and
    measuring a straggler initiator's delay against a leader's far-future
    busy horizon would book that drift — not contention — as queue delay.
    On the monotone clock a round only queues behind the handlers of
    rounds genuinely in flight around its own dispatch.
    """

    #: merge policy at a busy CPU: False = queue a new handler occupancy
    #: behind the pending one (this class); True = coalesce into it
    #: (:class:`CoalescingContention`).  The rest of the discrete-event
    #: skeleton — clock clamp, dispatch classes, inflight windows — is
    #: shared, so a fix to it can never diverge between the two models.
    merge_pending = False

    def __init__(self, *, handler_ns: float = IPI_RECEIVE_NS):
        self.handler_ns = float(handler_ns)
        self.busy_until: Dict[int, float] = {}   # cpu -> handler-free time
        self.initiator_until: Dict[int, float] = {}  # cpu -> ack-window end
        self.clock = 0.0                         # monotone round-start clock

    def settle(self, t_start, my_cpu, targets, node_of, cost
               ) -> RoundSettlement:
        if t_start > self.clock:
            self.clock = t_start
        else:
            t_start = self.clock
        my_node = node_of(my_cpu)
        busy = self.busy_until
        inflight = self.initiator_until
        handler = self.handler_ns
        merge = self.merge_pending
        disp_l = cost.ipi_dispatch_local_ns
        disp_r = cost.ipi_dispatch_remote_ns
        worst = 0.0
        queued = 0.0
        resp = 0.0
        stretch: Dict[int, float] = {}
        merged = []
        n_local = 0
        n_remote = 0
        for cpu in sorted(targets):
            local = node_of(cpu) == my_node
            if local:
                n_local += 1
                arrival = t_start + disp_l
            else:
                n_remote += 1
                arrival = t_start + disp_r
            free = busy.get(cpu, 0.0)
            extra = 0.0
            if free > arrival:
                delay = free - arrival
                queued += delay
                if delay > worst:
                    worst = delay
                if merge:
                    # coalesce into the pending handler: no new occupancy,
                    # no responder charge; the initiator waits it out
                    merged.append(cpu)
                    continue
                begin = free
                extra = delay            # responder stretched by its queue
            else:
                begin = arrival
            busy[cpu] = begin + handler
            fin = inflight.get(cpu)
            if fin is not None and fin > arrival:
                # responder-side initiator: mid-shootdown when the IPI
                # lands — its in-flight ack horizon extends by the handler
                inflight[cpu] = fin + handler
                extra += handler
            if extra:
                stretch[cpu] = extra
                resp += extra
        # record this initiator's in-flight ack window for later rounds
        inflight[my_cpu] = (t_start + cost.shootdown_cost_ns(n_local,
                                                             n_remote)
                            + worst)
        if queued == 0.0 and not stretch and not merged:
            return _ZERO
        return RoundSettlement(extra_wait_ns=worst, queued_ns=queued,
                               contended=queued > 0.0,
                               target_stretch=stretch,
                               responder_delay_ns=resp,
                               coalesced_cpus=(frozenset(merged) if merged
                                               else _NO_CPUS))

    def reset(self) -> None:
        self.busy_until.clear()
        self.initiator_until.clear()
        self.clock = 0.0


class CoalescingContention(QueueContention):
    """Receive queues with Linux-style flush coalescing.

    Same discrete-event state as :class:`QueueContention`, but an
    invalidation that arrives while the target CPU's handler is still
    pending *merges* into that handler: one handler occupancy serves all
    merged invalidations, so the busy horizon does not advance, the
    responder pays no new handler charge (the engines skip the thread
    charge for ``coalesced_cpus``), and the initiator only waits for the
    already-pending handler to finish (the queue delay).  Per-CPU total
    handler occupancy therefore never exceeds the queueing model's — the
    metamorphic property pinned by the test suite.

    This is the **default** overlap model (it is what real
    Linux does — its flush batching is exactly this merge), calibrated
    against Fig 1's absolute 280-spinner cliff: the cliff survives
    coalescing because it is dominated by the full-fan-out dispatch and
    ack of a process-wide round, not by handler queueing alone.
    :class:`QueueContention` stays selectable for the no-coalescing
    counterfactual (and keeps its own relative-cliff gates).
    """

    merge_pending = True


class HardwareCoherence(ContentionModel):
    """Hardware TLB coherence: zero IPIs, per-line invalidation messages.

    The third system alongside the software schemes (HATRIC,
    arXiv:1701.07517): TLBs participate in the cache-coherence protocol,
    so a PTE write invalidates remote translations with unicast coherence
    messages instead of a process-wide IPI broadcast.  Every software cost
    the contention engine models disappears — no dispatch, no
    interrupt-handler occupancy, no synchronous ack wait, no receive-queue
    contention — which makes this model the *upper bound* that decomposes
    the Fig 1 cliff: differencing a hardware run against a coalescing run
    on the identical trace splits each op's cost into ``dispatch_ack_ns``
    (the part only software pays) vs ``flush_work_ns`` (the part any
    scheme pays).

    What it *does* charge: per stale TLB entry actually cached on a target
    CPU, ``line_ns`` plus ``hop_ns`` per NUMA hop between the initiator's
    node and the target's node.  The engines count the stale lines
    (entries of the invalidated VPN range present in each target TLB),
    price the round via :meth:`line_cost_ns`, and deliver the charge
    through :func:`charge_responders` with ``count_ipis=False`` and the
    initiating ASID — so counters, thread-time float sequences, and
    cross-tenant isolation stay comparable with the software models.  The
    initiator pays only its own local ``tlb_invalidate_self_ns``; its cost
    is independent of fan-out, which is why no cliff survives.

    ``settle`` is never reached by the engines (they branch on
    ``ipi_free`` first) but is implemented as the zero settlement so the
    model honors the full :class:`ContentionModel` interface.
    """

    ipi_free = True
    handler_ns = 0.0  # no interrupt handler exists to occupy a CPU

    def __init__(self, *, line_ns: float = HW_LINE_INVALIDATE_NS,
                 hop_ns: float = HW_HOP_NS):
        self.line_ns = float(line_ns)
        self.hop_ns = float(hop_ns)

    def line_cost_ns(self, n_lines: int, hops: int) -> float:
        """Cost of invalidating ``n_lines`` stale entries ``hops`` away."""
        return n_lines * (self.line_ns + hops * self.hop_ns)

    def settle(self, t_start, my_cpu, targets, node_of, cost
               ) -> RoundSettlement:
        return _ZERO

    def reset(self) -> None:
        pass


#: selectable contention models by name (benchmark CLI / row labels).
CONTENTION_MODELS = {
    "null": NullContention,
    "queue": QueueContention,
    "coalescing": CoalescingContention,
    "hardware": HardwareCoherence,
}

#: the model ``concurrency="overlap"`` uses when none is given: Linux's
#: real flush-batching behavior (flipped from "queue" once the absolute
#: Fig 1 cliff was calibrated under coalescing — see CoalescingContention).
DEFAULT_OVERLAP_MODEL = "coalescing"


def make_contention(name: Optional[str]) -> ContentionModel:
    """Instantiate (or validate) a contention model.

    ``name`` may be a registry name (None = the overlap default), which
    returns a fresh instance, or an already-constructed
    :class:`ContentionModel` instance, which passes through unchanged —
    but only if its class is registered (or subclasses a registered
    model): an unregistered instance raises the same clear ``ValueError``
    an unknown name does, instead of leaking into the engines where its
    unknown settlement semantics would surface as silent divergence.
    """
    if name is None:
        name = DEFAULT_OVERLAP_MODEL
    if isinstance(name, ContentionModel):
        if not isinstance(name, tuple(CONTENTION_MODELS.values())):
            raise ValueError(
                f"unknown contention model {type(name).__name__!r}; pick "
                f"from {sorted(CONTENTION_MODELS)} (or subclass one)")
        return name
    try:
        return CONTENTION_MODELS[name]()
    except KeyError:
        raise ValueError(f"unknown contention model {name!r}; pick from "
                         f"{sorted(CONTENTION_MODELS)}") from None
