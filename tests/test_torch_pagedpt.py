"""Host block manager, block-table ops and the device page walk of the port
against the JAX package: the same op sequences through both, identical
counters and tables."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kvcache import PagedKVManager as JaxKV  # noqa: E402
from repro.pagedpt import BlockTableSpec as JaxSpec  # noqa: E402
from repro.pagedpt import HostBlockManager as JaxHost  # noqa: E402
from repro.pagedpt import blocktable as jbt  # noqa: E402
from repro_torch.kvcache import PagedKVManager  # noqa: E402
from repro_torch.pagedpt import (BlockTableSpec, CoherenceMode,  # noqa: E402
                                 HostBlockManager, apply_mutations,
                                 eager_sync_bytes, lookup_blocks,
                                 numapte_fetch_bytes, pack_entry, unpack_entry)
from repro_torch.pagedpt import blocktable as tbt  # noqa: E402

MODES = ["local", "eager", "numapte"]
SPEC_KW = dict(n_pods=4, n_tables=16, entries_per_table=32, miss_budget=8,
               prefetch_degree=2)


def _both_hosts(mode: str, **kw):
    kw = {**SPEC_KW, **kw}
    return (HostBlockManager(BlockTableSpec(**kw), CoherenceMode(mode)),
            JaxHost(JaxSpec(**kw), jbt.CoherenceMode(mode)))


def _assert_same_host(port, ref, n_frames=None):
    assert dataclasses.asdict(port.counters) == dataclasses.asdict(ref.counters)
    for name in ("canonical", "present", "sharers", "owner"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    # the port's KV manager hands out only the slabs' frames, in the same order
    assert port.frame_pools == [[f for f in ref.free_frames
                                 if n_frames is None or f < n_frames]]
    assert port.free_tables == ref.free_tables
    assert port.footprint_table_pages() == ref.footprint_table_pages()


def test_torch_constants_and_budgets_match():
    for name in ("ENTRIES_PER_TABLE", "PERM_SHIFT", "PERM_MASK", "FRAME_MASK",
                 "PERM_R", "PERM_W", "PERM_RW"):
        assert getattr(tbt, name) == getattr(jbt, name)
    assert [m.value for m in CoherenceMode] == [m.value for m in jbt.CoherenceMode]
    spec, jspec = BlockTableSpec(**SPEC_KW), JaxSpec(**SPEC_KW)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert spec.total_entries == jspec.total_entries
    assert eager_sync_bytes(spec) == jbt.eager_sync_bytes(jspec)
    assert numapte_fetch_bytes(spec) == jbt.numapte_fetch_bytes(jspec)


@pytest.mark.parametrize("mode", MODES)
def test_torch_host_roundtrip_matches_reference(mode):
    """The op sequence of test_alloc_translate_free_roundtrip."""
    port, ref = _both_hosts(mode)
    for mgr in (port, ref):
        blocks = mgr.alloc_sequence(0, 10, pod=1)
        for b in blocks:
            mgr.record_access(1, b)
        for b in blocks[:3]:
            mgr.record_access(2, b)
        mgr.check_invariants()
    _assert_same_host(port, ref)
    for mgr in (port, ref):
        mgr.protect_prefix(0, 4)
        mgr.extend_sequence(0, 30)          # spills into a second table page
        mgr.check_invariants()
    _assert_same_host(port, ref)
    for a, b in zip(port.drain_mutation_buffer(8), ref.drain_mutation_buffer(8)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.drain_miss_buffer(2), ref.drain_miss_buffer(2))
    for mgr in (port, ref):
        mgr.free_sequence(0)
        mgr.check_invariants()
    _assert_same_host(port, ref)
    assert port.footprint_table_pages() == 0


@pytest.mark.parametrize("mode", MODES)
def test_torch_sharer_filter_matches_reference(mode):
    """The op sequence of test_sharer_filter_scopes_invalidations."""
    port, ref = _both_hosts(mode)
    for mgr in (port, ref):
        mgr.alloc_sequence(0, 6, pod=0)
        mgr.free_sequence(0)
    _assert_same_host(port, ref)
    want = 1 if mode == "numapte" else SPEC_KW["n_pods"]
    assert port.counters.invalidations_sent == want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_host_random_ops_match_reference(mode, seed):
    """Seeded random alloc/extend/access/protect/free sequences (the
    vocabulary of test_host_manager_invariants) through both managers."""
    rng = np.random.default_rng(seed)
    port, ref = _both_hosts(mode, n_tables=32, entries_per_table=16,
                            prefetch_degree=1)
    live, next_id = [], 0
    for _ in range(60):
        kind = rng.choice(["alloc", "extend", "access", "protect", "free"])
        sel, pod, n = int(rng.integers(0, 6)), int(rng.integers(0, 4)), int(rng.integers(1, 9))
        outcome = []
        for mgr in (port, ref):
            try:
                if kind == "alloc":
                    mgr.alloc_sequence(next_id, n, pod)
                elif kind == "extend" and live:
                    mgr.extend_sequence(live[sel % len(live)], n)
                elif kind == "access" and live:
                    blocks = mgr.seqs[live[sel % len(live)]].logical_blocks
                    mgr.record_access(pod, blocks[(sel + n) % len(blocks)])
                elif kind == "protect" and live:
                    mgr.protect_prefix(live[sel % len(live)], n)
                elif kind == "free" and live:
                    mgr.free_sequence(live[sel % len(live)])
                outcome.append("ok")
            except MemoryError:
                outcome.append("oom")
        assert outcome[0] == outcome[1]
        if outcome[0] == "oom":
            break
        if kind == "alloc":
            live.append(next_id)
            next_id += 1
        elif kind == "free" and live:
            live.pop(sel % len(live))
        port.check_invariants()
        _assert_same_host(port, ref)


def test_torch_pack_unpack_lookup_bit_exact():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 1 << 28, 64).astype(np.int32)
    perms = rng.integers(0, 8, 64).astype(np.int32)
    packed = pack_entry(torch.from_numpy(frame), torch.from_numpy(perms))
    jpacked = jbt.pack_entry(jnp.asarray(frame), jnp.asarray(perms))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    entry = np.concatenate([packed.numpy(), np.full(8, -1, np.int32)])
    for got, want in zip(unpack_entry(torch.from_numpy(entry)),
                         jbt.unpack_entry(jnp.asarray(entry))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # test_device_lookup_matches_host, through both
    port, ref = _both_hosts("numapte")
    blocks = port.alloc_sequence(0, 12, pod=0)
    assert blocks == ref.alloc_sequence(0, 12, pod=0)
    logical = np.asarray(blocks + [-1, 10_000, 511, 512], np.int32).reshape(2, 8)
    frames, ok = lookup_blocks(torch.from_numpy(port.canonical),
                               torch.from_numpy(logical))
    jframes, jok = jbt.lookup_blocks(jnp.asarray(ref.canonical), jnp.asarray(logical))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert frames.dtype == torch.int32 and bool(ok.reshape(-1)[:12].all())
    assert not bool(ok.reshape(-1)[12:].any())


def test_torch_apply_mutations_matches_reference_and_orders_duplicates():
    rng = np.random.default_rng(0)
    n_tables, epb, n = 6, 16, 40
    entries = rng.integers(-1, 1 << 20, (n_tables, epb)).astype(np.int32)
    slots = rng.permutation(n_tables * epb - 1)[:n]       # unique, dummy slot free
    tables, idx = (slots // epb).astype(np.int32), (slots % epb).astype(np.int32)
    value = rng.integers(-1, 1 << 20, n).astype(np.int32)
    mask = rng.random(n) > 0.3
    want = jbt.apply_mutations(*(jnp.asarray(a) for a in
                                 (entries, tables, idx, value, mask)))
    table = torch.from_numpy(entries.copy())
    got = apply_mutations(table, *(torch.from_numpy(a) for a in
                                   (tables, idx, value, mask)))
    assert got is table                                   # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # one slot named three times: the last applied mutation wins, a masked
    # later one does not; a masked-out slot 0 (the drain's filler) is inert
    table = torch.from_numpy(entries.copy())
    apply_mutations(table,
                    torch.tensor([2, 2, 2, 2, 0], dtype=torch.int32),
                    torch.tensor([5, 5, 5, 5, 0], dtype=torch.int32),
                    torch.tensor([11, 22, 33, 44, 99], dtype=torch.int32),
                    torch.tensor([True, True, True, False, False]))
    want = entries.copy()
    want[2, 5] = 33
    np.testing.assert_array_equal(table.numpy(), want)


def _both_kv(n_pods, mode="numapte", **kw):
    args = dict(n_frames=64, block_tokens=4, max_blocks_per_seq=8, n_pods=n_pods, **kw)
    return (PagedKVManager(mode=CoherenceMode(mode), device="cpu", **args),
            JaxKV(mode=jbt.CoherenceMode(mode), **args))


@pytest.mark.parametrize("mode", MODES)
def test_torch_physical_tables_match_reference(mode):
    """The device walk (on the CPU: plain pte_gather over the device-resident
    table) returns what the reference's numpy walk returns, with the same
    host counters — live rows, padding rows, explicit pod, record on/off,
    across frees and re-allocations that reuse table slots."""
    port, ref = _both_kv(4, mode)
    for kv in (port, ref):
        for sid in range(4):
            kv.start_sequence(sid, prompt_len=12, pod=sid % 4)
    for ids, kw in [([0, 1, 2, 3], {}), ([0, -1, 2, -1], {}),
                    ([3, 2, 1, 0], {"record": False}), ([0, 1], {"pod": 2})]:
        got, want = port.physical_tables(ids, **kw), ref.physical_tables(ids, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(port.logical_tables(ids), ref.logical_tables(ids))
        _assert_same_host(port.host, ref.host, port.n_frames)
    for kv in (port, ref):
        kv.maybe_extend(1, 30)
        kv.finish_sequence(0)
        kv.finish_sequence(2)
        kv.start_sequence(7, prompt_len=20, pod=3)    # reuses freed slots
    ids = [7, 1, 3, -1]
    np.testing.assert_array_equal(port.physical_tables(ids).numpy(),
                                  ref.physical_tables(ids))
    _assert_same_host(port.host, ref.host, port.n_frames)
    port.check_device_table()
    # (the reference's utilization() counts its over-long free list and goes
    # negative; the port's counts the slabs' frames)
    in_use = sum(len(s.logical_blocks) for s in port.host.seqs.values())
    assert port.utilization() == in_use / port.n_frames
    assert port.footprint_pages() == ref.footprint_pages()
    # the reference's ServingStats counts the sequences started and finished;
    # the port keeps them in its host counters only
    assert (ref.stats.seqs_started, ref.stats.seqs_finished) == (
        port.host.counters.allocs, port.host.counters.frees) == (5, 2)


def test_torch_padding_rows_are_inert_in_tables_and_counters():
    """test_padding_rows_are_inert_in_tables_and_counters, on the port."""
    def run(batch_ids):
        kv, _ = _both_kv(2)
        kv.start_sequence(0, prompt_len=12, pod=1)
        assert (kv.logical_tables([-1]) == -1).all()
        return kv.physical_tables(batch_ids).numpy(), dataclasses.asdict(kv.host.counters)

    solo, c_solo = run([0])
    padded, c_pad = run([0, -1, -1, -1])
    assert (padded[0] == solo[0]).all() and (padded[1:] == -1).all()
    assert c_pad == c_solo


def test_torch_fetches_nonzero_across_pods_only():
    """test_numapte_fetches_nonzero_across_pods, on the port."""
    def fetches(n_pods, home, **kw):
        kv, _ = _both_kv(n_pods)
        for sid in range(4):
            kv.start_sequence(sid, prompt_len=12, pod=home(sid))
        kv.physical_tables([0, 1, 2, 3], **kw)
        kv.host.check_invariants()
        return kv.host.counters

    assert fetches(4, lambda s: s % 4).fetches > 0
    assert fetches(4, lambda s: s % 4).translation_local > 0
    assert fetches(1, lambda s: 0).fetches == 0
    assert fetches(4, lambda s: 0, pod=0).fetches == 0


def test_torch_mutation_backlog_beyond_budget_is_drained():
    """One wave can queue more mutations than one drain returns (budget
    1024): the walk drains until the buffer is empty."""
    kv = PagedKVManager(n_frames=2048, block_tokens=4, max_blocks_per_seq=600,
                        n_pods=1, device="cpu")
    for sid in range(3):
        kv.start_sequence(sid, prompt_len=4 * 500, pod=0)
    assert len(kv.host._pending_mut) == 1500 > kv.spec.mutation_budget
    tables = kv.physical_tables([0, 1, 2], record=False).numpy()
    assert (tables[:, :500] >= 0).all() and (tables[:, 500:] == -1).all()
    assert len(np.unique(tables[:, :500])) == 1500
    kv.check_device_table()


def test_torch_frames_beyond_the_slabs_raise():
    """The reference's host hands out frame ids up to n_tables * 512, past a
    smaller slab pool (JAX clamps the gather silently); the port hands out
    only the slabs' frames and then raises."""
    port, ref = _both_kv(1)
    assert port.n_frames == 64 < port.spec.total_entries
    for kv in (port, ref):
        kv.start_sequence(0, prompt_len=4 * 64, pod=0)       # all 64 frames
    frames = port.host.canonical[port.host.canonical >= 0] & tbt.FRAME_MASK
    assert sorted(frames) == list(range(64)) and port.host.frame_pools == [[]]
    ref.start_sequence(1, prompt_len=4, pod=0)               # frame 64: no error
    assert ref.physical_tables([1]).max() == 64 >= ref.n_frames
    with pytest.raises(MemoryError):
        port.start_sequence(1, prompt_len=4, pod=0)
    with pytest.raises(MemoryError):
        port.maybe_extend(0, 4 * 64 + 1)
