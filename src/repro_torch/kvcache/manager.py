"""Paged KV-cache manager: sequences -> logical blocks -> physical frames.

The serving-side owner of the numaPTE substrate.  Each active sequence holds
a list of *logical* blocks (stable ids, the VMA analogue); the
``HostBlockManager`` maps them to physical KV frames and maintains the
per-pod replicas, sharer masks and invalidation filtering.  Every decode
step translates the logical tables to physical tables — the page walk — and
hands the physical tables to the paged-attention kernel.

The walk runs on the device: the manager keeps a device-resident copy of the
host's canonical table ``[n_tables, entries_per_table]`` int32.  Each walk
drains the host's mutation buffer until it is empty, packs the drained
mutations and the logical ids into one host staging buffer, sends it with one
``non_blocking`` copy, and makes one ``pte_gather`` launch that applies the
mutations to the device table and then translates (on the CPU: the plain
version of the same).  Nothing on the walk waits for the device.  The host
loop still records every access (the protocol and its counters).

Pool-partitioned KV (``n_pools`` > 1): each pool has its own free list of
pool-local frame ids, and a sequence takes its frames from its home pod's
pool, so ``physical_tables`` returns ids local to a row's pool.  With ``replicas`` the manager also keeps the per-pod device replicas
``[n_pods, n_tables, epb]`` that the coherence collectives
(``pagedpt.coherence``) maintain: every mutation the walk drains is queued
for them too (one drain, two consumers, the same entries in the same order),
and ``coherence_inputs`` hands a step's share of that queue and the host's
per-pod miss buffers to the prologue.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from .._device import DeviceLike, resolve_device
from ..kernels.pte_gather.ops import pte_gather
from ..pagedpt import BlockTableSpec, HostBlockManager
from ..pagedpt.blocktable import CoherenceMode
from .staging import StagingRing


class PagedKVManager:
    """Host-side manager for a fixed-capacity paged KV pool."""

    def __init__(self, *, n_frames: int, block_tokens: int = 16,
                 max_blocks_per_seq: int, n_pods: int = 1,
                 mode: CoherenceMode = CoherenceMode.NUMAPTE,
                 entries_per_table: int = 512, prefetch_degree: int = 3,
                 n_pools: int = 1, replicas: bool = False,
                 device: DeviceLike = None):
        # table pages are metadata (one per active sequence at minimum, each
        # sequence opens its own VMA/table): keep a healthy pool
        n_tables = max(64, -(-n_frames // entries_per_table))
        self.spec = BlockTableSpec(
            n_pods=n_pods, n_tables=n_tables,
            entries_per_table=entries_per_table,
            prefetch_degree=prefetch_degree)
        self.host = HostBlockManager(self.spec, mode,
                                     block_tokens=block_tokens)
        # The host's free list spans every table entry, which can be more
        # than the slabs hold.  A frame id beyond the slabs would make the
        # attention kernel read out of bounds, so only the slabs' frames are
        # handed out (in the same order) and running out raises MemoryError;
        # pooled slabs split them into ``n_pools`` lists of pool-local ids.
        if n_frames % n_pools:
            raise ValueError(f"{n_frames} frames do not split into {n_pools} "
                             "pools")
        f_local = n_frames // n_pools
        self.host.frame_pools = [list(range(f_local))[::-1]
                                 for _ in range(n_pools)]
        self.n_pools = n_pools
        self.block_tokens = block_tokens
        self.max_blocks = max_blocks_per_seq
        self.n_frames = n_frames
        self._seq_pod: Dict[int, int] = {}
        #: the scheduler's pod: it walks every row's tail block to commit
        #: appended tokens (see ``physical_tables``)
        self.scheduler_pod = 0
        self.device = resolve_device(device)
        #: device-resident copy of ``host.canonical``, the table the walk reads
        self.device_table = torch.full((n_tables, entries_per_table), -1,
                                       dtype=torch.int32, device=self.device)
        self._staging = StagingRing(self.device)
        #: per-pod replicas of the table, kept by the coherence collectives
        self.replicas = (torch.full((n_pods, n_tables, entries_per_table), -1,
                                    dtype=torch.int32, device=self.device)
                         if replicas else None)
        self._coherence_queue: List[Tuple[np.ndarray, ...]] = []

    # ------------------------------------------------------------- lifecycle
    def start_sequence(self, seq_id: int, prompt_len: int, pod: int = 0
                       ) -> None:
        """With partitioned frames the sequence's frames come from its home
        ``pod``'s pool."""
        with tracing.span("kv.admit"):
            n_blocks = max(1, -(-prompt_len // self.block_tokens))
            pool = pod if self.n_pools > 1 else 0
            if pool >= self.n_pools:
                raise ValueError(f"pod {pod} has no pool of the "
                                 f"{self.n_pools}")
            self.host.alloc_sequence(seq_id, n_blocks, pod, pool)
            self._seq_pod[seq_id] = pod

    def maybe_extend(self, seq_id: int, new_len: int) -> None:
        with tracing.span("kv.extend"):
            have = len(self.host.seqs[seq_id].logical_blocks)
            need = -(-new_len // self.block_tokens)
            if need > have:
                self.host.extend_sequence(seq_id, need - have)

    def finish_sequence(self, seq_id: int) -> None:
        self.host.free_sequence(seq_id)
        self._seq_pod.pop(seq_id, None)

    # ------------------------------------------------------------ tables
    def logical_tables(self, seq_ids: List[int]) -> np.ndarray:
        """[len(seq_ids), max_blocks] logical block ids, -1 padded.  A
        negative seq id is an inactive batch row (wave padding): its table
        stays all -1 so the device masks it out of update and gather."""
        out = np.full((len(seq_ids), self.max_blocks), -1, np.int32)
        for r, sid in enumerate(seq_ids):
            if sid < 0:
                continue
            blocks = self.host.seqs[sid].logical_blocks
            out[r, :len(blocks)] = blocks[:self.max_blocks]
        return out

    def _walk(self, logical: np.ndarray) -> torch.Tensor:
        """The device side of the page walk: every pending host mutation,
        then ``logical`` [M] int32, in one copy and one ``pte_gather`` launch.
        One drain returns at most ``mutation_budget`` entries and a prefill
        wave can queue more, so drain until the buffer is empty.  Returns the
        frames [M] on the device."""
        with tracing.span("kv.stage"):
            drains = []
            while True:
                tables, idx, val, valid = self.host.drain_mutation_buffer()
                n = int(valid.sum())         # the drain fills a prefix
                if n == 0:
                    break
                drains.append((tables[:n], idx[:n], val[:n], valid[:n]))
            cols = ([np.concatenate(col) for col in zip(*drains)] if drains
                    else None)
            if drains and self.replicas is not None:
                self._coherence_queue.append(tuple(cols[:3]))
            n, M = (cols[0].size if drains else 0), logical.size
            if n == 0 and M == 0:
                return torch.empty((0,), dtype=torch.int32,
                                   device=self.device)
            # bytes: table, idx, value and logical as int32, then applied as
            # bool
            n_words = 3 * n + M

            def fill(buf: np.ndarray) -> None:
                words = buf[:4 * n_words].view(np.int32)
                if n:
                    words[:3 * n] = np.concatenate(cols[:3])
                    buf[4 * n_words:] = cols[3]
                words[3 * n:] = logical

            dev = self._staging.send(fill, 4 * n_words + n)
            words = dev[:4 * n_words].view(torch.int32)
            mutations = (words[:n], words[n:2 * n], words[2 * n:3 * n],
                         dev[4 * n_words:].view(torch.bool)) if n else None
        with tracing.span("k3"):
            frames, _, _ = pte_gather(self.device_table, words[3 * n:],
                                      self.spec.prefetch_degree, mutations)
        return frames

    def sync_device_table(self) -> None:
        """Apply every pending host mutation to the device table, in order
        (the walk's launch with no ids)."""
        self._walk(np.empty((0,), np.int32))

    def physical_tables(self, seq_ids: List[int],
                        pod: Optional[int] = None,
                        record: bool = True) -> torch.Tensor:
        """Translate to physical frame ids (the page walk); returns an int32
        tensor [len(seq_ids), max_blocks] on the device, -1 = unmapped.

        ``pod=None`` (the serving default) walks each row through its
        *home* pod — the attention shard that owns the sequence's pool, so
        the common-case walk is replica-local — and additionally records
        the scheduler pod's walk of the row's tail block (the scheduler
        commits the appended token through its own replica).  The scheduler's
        walks are what generate real cross-pod fetch/prefetch traffic
        under NUMAPTE once sequences are homed off pod 0.  An explicit
        ``pod`` keeps the legacy single-pod walk.  Misses trigger the
        numaPTE on-demand fetch protocol; negative seq ids (padding rows)
        are skipped entirely."""
        with tracing.span("kv.walk"):
            logical = self.logical_tables(seq_ids)
            if record:
                self._record(seq_ids, logical, pod)
            return self._walk(logical.reshape(-1)).view(logical.shape)

    def _record(self, seq_ids: List[int], logical: np.ndarray,
                pod: Optional[int]) -> None:
        """The host protocol's record of the walk's accesses (see
        ``physical_tables``); its span counts the accesses, the misses and
        the on-demand fetches (``HostCounters`` deltas)."""
        c = self.host.counters
        local, miss, fetches = (c.translation_local, c.translation_miss,
                                c.fetches)
        with tracing.span("kv.record") as rec:
            for r, sid in enumerate(seq_ids):
                if sid < 0:
                    continue
                walk_pod = self._seq_pod[sid] if pod is None else pod
                blocks = logical[r][logical[r] >= 0]
                for lb in blocks:
                    self.host.record_access(walk_pod, int(lb))
                if (pod is None and blocks.size
                        and walk_pod != self.scheduler_pod):
                    self.host.record_access(self.scheduler_pod, int(blocks[-1]))
            if rec:
                miss = c.translation_miss - miss
                rec.counts.update(
                    accesses=c.translation_local - local + miss, misses=miss,
                    fetches=c.fetches - fetches)

    def check_device_table(self) -> None:
        """The device table, brought up to date, equals the host's canonical
        table entry for entry."""
        self.sync_device_table()
        if not np.array_equal(self.device_table.cpu().numpy(),
                              self.host.canonical):
            raise AssertionError("device block table differs from the host's")

    # ------------------------------------------------------------ coherence
    def coherence_pending(self) -> bool:
        """Whether drained mutations or recorded misses still wait for the
        replicas."""
        return bool(self._coherence_queue) or any(
            self.host._pending_miss.values())

    def coherence_inputs(self, mutation_budget: Optional[int] = None,
                         miss_budget: Optional[int] = None
                         ) -> Tuple[torch.Tensor, ...]:
        """One step's coherence buffers, on the device: (sharers [T] int64,
        owner [T] int32, mut_tables, mut_idx, mut_value [P, B] int32,
        mut_valid [P, B] bool, miss [P, M] int32).  The queued mutations, in
        program order, fill pod 0's buffer first, then pod 1's ... (the
        pod-major all-gather keeps their order); what does not fit waits for
        the next call.  Pod p's misses are its own (``drain_miss_buffer``)."""
        with tracing.span("coherence.inputs") as rec:
            P = self.spec.n_pods
            B = mutation_budget or self.spec.mutation_budget
            M = miss_budget or self.spec.miss_budget
            queued = ([np.concatenate(c) for c in zip(*self._coherence_queue)]
                      if self._coherence_queue
                      else [np.empty(0, np.int32)] * 3)
            n = min(queued[0].size, P * B)
            rest = [c[n:] for c in queued]
            self._coherence_queue = [tuple(rest)] if rest[0].size else []
            tables = np.zeros(P * B, np.int32)
            idx = np.zeros(P * B, np.int32)
            value = np.full(P * B, -1, np.int32)
            valid = np.zeros(P * B, bool)
            tables[:n], idx[:n], value[:n] = (c[:n] for c in queued)
            valid[:n] = True
            miss = np.stack([self.host.drain_miss_buffer(p, M)
                             for p in range(P)])
            if rec:
                rec.counts.update(mutations=n, misses=int((miss >= 0).sum()),
                                  mutation_slots=P * B, miss_slots=P * M)
            dev = lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).to(self.device)
            return (dev(self.host.sharers.astype(np.int64)),
                    dev(self.host.owner),
                    *(dev(a.reshape(P, B))
                      for a in (tables, idx, value, valid)),
                    dev(miss))

    def replica_mismatches(self, full: bool) -> int:
        """Entries where a replica differs from the host's canonical table:
        everywhere (``full``: an eager replica holds every entry), or only
        where ``host.present`` says the pod holds the entry (numaPTE's
        partial replicas)."""
        got = self.replicas.cpu().numpy()
        want = np.broadcast_to(self.host.canonical, got.shape)
        where = (np.ones(got.shape, bool) if full else self.host.present)
        return int(((got != want) & where).sum())

    # ------------------------------------------------------------ accounting
    def utilization(self) -> float:
        free = sum(map(len, self.host.frame_pools))
        return 1.0 - free / self.n_frames

    def footprint_pages(self) -> int:
        return self.host.footprint_table_pages()
