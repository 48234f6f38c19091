"""User-level allocator models on top of the simulator's mmap/munmap.

The paper's malloc case study (Figs 11/12) compares three allocators whose
relevant difference is *how often they issue mmap/munmap* (i.e., how much
page-table mutation and TLB-shootdown traffic they generate):

  * ``mmap``     — every allocation is mmap'd, every free munmap'd.
  * ``glibc``    — arena allocator with glibc's *dynamic* mmap threshold:
    allocations at or above ``M_MMAP_THRESHOLD`` (128KB initially) go to
    mmap, but freeing an mmapped block ratchets the threshold up to that
    block's size (capped at 32MB) and the trim threshold to twice that —
    so the paper's ~3.3MB Gamma sizes are absorbed by the arena after the
    first free, exactly the adaptive behaviour real glibc ships.  The
    arena trims back to the OS (munmap) only above the trim threshold.
  * ``tcmalloc`` — thread-caching allocator; spans are cached per thread
    and *decommitted* (``madvise_dontneed``: VA kept, pages zapped)
    rather than unmapped when the cache cap is exceeded, so steady-state
    alloc/free cycles touch page-tables only on cache misses and the
    freed VA is recycled — the reuse regime flush elision targets.

Both caching flavors share the span machinery: an address-ordered,
order-bucketed buddy free-list (``_BuddyCache``) that coalesces adjacent
spans on insert and serves carve-offs first-fit from the matching size
bucket — O(1)-ish instead of the previous O(n) best-fit scan over an
ever-fragmenting span list — plus per-thread slab magazines (LIFO stacks
of fixed-size small spans) in front of it.

Sizes follow the paper: Gamma-distributed with mean ~3.3MB.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .pagetable import PAGE_BYTES
from .sim import NumaSim

MMAP_THRESHOLD_PAGES = 32          # 128KB / 4KB: glibc's initial threshold
MMAP_THRESHOLD_MAX_PAGES = 8192    # DEFAULT_MMAP_THRESHOLD_MAX: 32MB
GLIBC_TRIM_PAGES = 32              # initial trim threshold (128KB)
TCMALLOC_CACHE_PAGES = 1 << 18     # 1GB span cache per thread
GLIBC_HEAP_PAGES = 4096            # 16MB arena-growth slab (glibc heaps)
SLAB_MAX_PAGES = 8                 # magazine-eligible span size (<= 32KB)
SLAB_MAGAZINE_CAP = 32             # per-size magazine depth


def gamma_sizes_pages(rng: np.random.Generator, n: int,
                      mean_bytes: float = 3.3e6, shape: float = 2.0) -> np.ndarray:
    """Allocation sizes (in pages) ~ Gamma with the paper's ~3.3MB mean."""
    scale = mean_bytes / shape
    sizes = rng.gamma(shape, scale, size=n)
    return np.maximum(1, (sizes / PAGE_BYTES).astype(np.int64))


@dataclasses.dataclass
class _Span:
    start_vpn: int
    n_pages: int
    mmapped: bool = False   # glibc: block went to mmap, free must munmap


class _BuddyCache:
    """Address-ordered free-list with order buckets and span coalescing.

    Spans are keyed by start vpn; a parallel end->start index makes
    left/right neighbour merges O(1) on ``insert``.  For allocation the
    spans are additionally bucketed by size order (``n.bit_length()``):
    ``take(n)`` first-fits inside bucket ``n.bit_length()`` (the only
    bucket that can hold a fit smaller than 2^ceil) and otherwise pops
    from the smallest higher bucket, carving the request off the front
    and re-listing the remainder — the classic buddy/segregated-fit
    shape, without the O(spans) best-fit scan of the old model.
    """

    __slots__ = ("_spans", "_by_end", "_orders", "cached_pages")

    def __init__(self):
        self._spans: Dict[int, int] = {}            # start -> n_pages
        self._by_end: Dict[int, int] = {}           # start+n -> start
        self._orders: Dict[int, Dict[int, None]] = {}  # order -> start set
        self.cached_pages = 0

    def __len__(self) -> int:
        return len(self._spans)

    def _link(self, start: int, n: int) -> None:
        self._spans[start] = n
        self._by_end[start + n] = start
        self._orders.setdefault(n.bit_length(), {})[start] = None

    def _unlink(self, start: int) -> int:
        n = self._spans.pop(start)
        del self._by_end[start + n]
        order = self._orders[n.bit_length()]
        del order[start]
        if not order:
            del self._orders[n.bit_length()]
        return n

    def insert(self, start: int, n: int) -> None:
        """Add [start, start+n), merging with adjacent cached spans."""
        self.cached_pages += n
        left = self._by_end.get(start)
        if left is not None:
            n += self._unlink(left)
            start = left
        right = self._spans.get(start + n)
        if right is not None:
            self._unlink(start + n)
            n += right
        self._link(start, n)

    def take(self, n: int) -> Optional[int]:
        """Carve exactly ``n`` pages off a cached span; returns its start
        vpn, or None when no span is large enough."""
        orders = self._orders
        if not orders:
            return None
        start = None
        bucket = orders.get(n.bit_length())
        if bucket is not None:
            # this bucket holds sizes in [2^(k-1), 2^k): some may still
            # be smaller than n, hence the first-fit check
            spans = self._spans
            for s in bucket:
                if spans[s] >= n:
                    start = s
                    break
        if start is None:
            higher = [k for k in orders if k > n.bit_length()]
            if not higher:
                return None
            start = next(iter(orders[min(higher)]))
        total = self._unlink(start)
        self.cached_pages -= n
        if total > n:
            # remainder re-lists as-is (nothing adjacent: it was just
            # split off a free span)
            self._link(start + n, total - n)
        return start

    def pop_highest(self) -> Optional[Tuple[int, int]]:
        """Remove and return the highest-addressed (start, n) span."""
        if not self._by_end:
            return None
        start = self._by_end[max(self._by_end)]
        n = self._unlink(start)
        self.cached_pages -= n
        return start, n

    def pop_lowest(self) -> Optional[Tuple[int, int]]:
        """Remove and return the lowest-addressed (start, n) span — the
        *oldest* memory under a monotonic VA allocator.  Trim evicts from
        this end: glibc recycles its recently freed top chunk and
        releases old memory, and the model's analog of "the top chunk"
        is the newest (highest-addressed) span — evicting that instead
        would munmap exactly the span the next allocation wants."""
        if not self._spans:
            return None
        start = min(self._spans)
        n = self._unlink(start)
        self.cached_pages -= n
        return start, n


class MallocModel:
    """One allocator instance bound to one simulator thread.

    ``stats`` tracks where allocations were served from
    (``arena_allocs`` vs ``mmap_allocs``, with ``magazine_hits`` /
    ``cache_hits`` / ``cold_hits`` as the arena breakdown) and how many
    release syscalls were issued (``munmaps`` / ``madvises``) — the
    observables the paper-claims gates assert on.  ``cache_cap_pages``
    bounds the tcmalloc committed span cache (tests shrink it to force
    decommit/reuse cycles).
    """

    def __init__(self, sim: NumaSim, tid: int, flavor: str = "glibc",
                 engine: Optional[str] = None,
                 cache_cap_pages: int = TCMALLOC_CACHE_PAGES):
        if flavor not in ("mmap", "glibc", "tcmalloc"):
            raise ValueError(flavor)
        self.sim = sim
        self.tid = tid
        self.flavor = flavor
        # "batch" (vectorized, byte-identical) | "scalar"; defaults to the
        # sim's SimConfig.engine
        self.engine = engine if engine is not None else sim.config.engine
        self._cache = _BuddyCache()      # committed spans (arena/span cache)
        self._cold = _BuddyCache()       # tcmalloc: decommitted-but-mapped VA
        self._magazines: Dict[int, List[int]] = {}   # size -> start stack
        self.mmap_threshold = MMAP_THRESHOLD_PAGES   # dynamic (glibc)
        self.trim_threshold = GLIBC_TRIM_PAGES       # dynamic (glibc)
        self.cache_cap_pages = int(cache_cap_pages)
        self.stats: Dict[str, int] = {
            "arena_allocs": 0, "mmap_allocs": 0, "magazine_hits": 0,
            "cache_hits": 0, "cold_hits": 0, "munmaps": 0, "madvises": 0}

    # -- public API -----------------------------------------------------------
    def alloc(self, n_pages: int, touch: bool = True) -> _Span:
        n = int(n_pages)
        span = self._take(n)
        if span is None:
            if self.flavor == "glibc" and n < self.mmap_threshold:
                # arena growth: glibc extends its arenas in large mmapped
                # heap slabs and carves requests off the top chunk, so
                # one grow syscall serves many subsequent allocations
                # (they surface here as cache hits).
                slab = max(n, GLIBC_HEAP_PAGES)
                vma = self.sim.mmap(self.tid, slab)
                if slab > n:
                    self._cache.insert(vma.start_vpn + n, slab - n)
                span = _Span(vma.start_vpn, n, False)
            else:
                vma = self.sim.mmap(self.tid, n)
                span = _Span(vma.start_vpn, n,
                             self.flavor in ("mmap", "glibc"))
            self.stats["mmap_allocs"] += 1
        else:
            self.stats["arena_allocs"] += 1
        if touch:
            # first-touch the allocation (glibc memset-on-use analogue):
            # touch one page per 16 to model sparse initialization quickly.
            step = 16 if n > 64 else 1
            if self.engine == "scalar":
                for vpn in range(span.start_vpn,
                                 span.start_vpn + span.n_pages, step):
                    self.sim.touch(self.tid, vpn, write=True)
            else:
                self.sim.touch_batch(
                    self.tid,
                    np.arange(span.start_vpn, span.start_vpn + span.n_pages,
                              step, dtype=np.int64), write_mask=True)
        return span

    def free(self, span: _Span) -> None:
        if self.flavor == "mmap":
            self._munmap_many([(span.start_vpn, span.n_pages)])
            return
        if self.flavor == "glibc":
            if span.mmapped:
                self._munmap_many([(span.start_vpn, span.n_pages)])
                n = span.n_pages
                if n >= self.mmap_threshold:
                    # glibc's dynamic M_MMAP_THRESHOLD: freeing an mmapped
                    # chunk ratchets the threshold to its size (the +1
                    # models the chunk header: an equal-sized request now
                    # falls below the threshold) and the trim threshold
                    # to twice that, so the arena absorbs this size class
                    # from now on.
                    self.mmap_threshold = min(n + 1,
                                              MMAP_THRESHOLD_MAX_PAGES)
                    self.trim_threshold = 2 * self.mmap_threshold
                return
            self._release(span)
            self._trim_glibc()
            return
        # tcmalloc: cache aggressively, decommit only beyond the cap
        self._release(span)
        self._trim_tcmalloc()

    # -- internals --------------------------------------------------------------
    def _take(self, n: int) -> Optional[_Span]:
        if self.flavor == "mmap":
            return None
        if self.flavor == "glibc" and n >= self.mmap_threshold:
            return None
        if n <= SLAB_MAX_PAGES:
            mag = self._magazines.get(n)
            if mag:
                self.stats["magazine_hits"] += 1
                return _Span(mag.pop(), n)
        start = self._cache.take(n)
        if start is not None:
            self.stats["cache_hits"] += 1
            return _Span(start, n)
        if self.flavor == "tcmalloc":
            start = self._cold.take(n)
            if start is not None:
                # decommitted VA: still mapped, pages refault on touch
                self.stats["cold_hits"] += 1
                return _Span(start, n)
        return None

    def _release(self, span: _Span) -> None:
        n = span.n_pages
        if n <= SLAB_MAX_PAGES:
            mag = self._magazines.setdefault(n, [])
            mag.append(span.start_vpn)
            if len(mag) > SLAB_MAGAZINE_CAP:
                # spill the coldest half back to the buddy cache (where
                # adjacent spills re-coalesce)
                keep = SLAB_MAGAZINE_CAP // 2
                spill, self._magazines[n] = mag[:-keep], mag[-keep:]
                for start in spill:
                    self._cache.insert(start, n)
            return
        self._cache.insert(span.start_vpn, n)

    def _trim_glibc(self) -> None:
        victims: List[Tuple[int, int]] = []
        cache = self._cache
        while cache.cached_pages > self.trim_threshold:
            victims.append(cache.pop_lowest())
        if victims:
            self._munmap_many(victims)

    def _trim_tcmalloc(self) -> None:
        cache = self._cache
        victims: List[Tuple[int, int]] = []
        while cache.cached_pages > self.cache_cap_pages:
            victims.append(cache.pop_lowest())
        if not victims:
            return
        self.stats["madvises"] += len(victims)
        if self.engine == "scalar" or len(victims) == 1:
            for start, n in victims:
                self.sim.madvise_dontneed(self.tid, start, n)
        else:
            self.sim.apply_mm_ops([("madvise", self.tid, start, n)
                                   for start, n in victims])
        for start, n in victims:
            self._cold.insert(start, n)

    def _munmap_many(self, victims: List[Tuple[int, int]]) -> None:
        self.stats["munmaps"] += len(victims)
        if self.engine == "scalar" or len(victims) == 1:
            for start, n in victims:
                self.sim.munmap(self.tid, start, n)
        else:
            self.sim.munmap_batch(self.tid,
                                  [s for s, _ in victims],
                                  [n for _, n in victims])

    # -- introspection (regression tests) ---------------------------------------
    @property
    def cached_span_count(self) -> int:
        """Spans in the committed cache (bounded: coalescing regression)."""
        return len(self._cache)

    @property
    def cached_pages(self) -> int:
        return self._cache.cached_pages
