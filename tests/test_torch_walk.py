"""The device page walk of the port — mutation drain, walk and prefetch
window in one call — against the JAX package's composition of
``apply_mutations`` and ``pte_gather_ref``, and the manager that feeds it one
staged copy a walk.

On CPU tensors the wrapper takes its plain version (``pte_gather_ref``), so
these tests run without a GPU; the kernel itself is held against the same
plain version on the card by ``chipcheck/walk.py``.  Inputs come from seeded
numpy generators.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.pte_gather.ref import pte_gather_ref as jax_pte_ref  # noqa: E402
from repro.kvcache import PagedKVManager as JaxKV  # noqa: E402
from repro.pagedpt import blocktable as jbt  # noqa: E402
from repro_torch.kernels.pte_gather import pte_gather  # noqa: E402
from repro_torch.kvcache import PagedKVManager  # noqa: E402
from repro_torch.kvcache import manager as manager_mod  # noqa: E402
from repro_torch.kvcache.staging import StagingRing  # noqa: E402
from repro_torch.pagedpt import CoherenceMode  # noqa: E402


def _entries(rng, T, epb):
    entries = np.full((T, epb), -1, np.int32)
    mask = rng.random((T, epb)) > 0.4
    entries[mask] = (rng.integers(0, 1 << 20, mask.sum()) | (3 << 28)).astype(np.int32)
    return entries


def _values(rng, n):
    v = (rng.integers(0, 1 << 20, n) | (3 << 28)).astype(np.int32)
    v[rng.random(n) < 0.3] = -1                  # frees
    return v


def _mutations(slots, epb, values, applied):
    return ((slots // epb).astype(np.int32), (slots % epb).astype(np.int32),
            values.astype(np.int32), applied.astype(bool))


def _torch(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _fused(entries, logical, degree, muts):
    """The port's fused call on CPU tensors: (frames, present, window, table)."""
    table = torch.from_numpy(entries.copy())
    out = pte_gather(table, torch.from_numpy(logical), degree,
                     None if muts is None else _torch(muts))
    return tuple(t.numpy() for t in out) + (table.numpy(),)


def _sequential(entries, muts):
    """The mutation list's meaning, one mutation at a time in program order."""
    out = entries.copy()
    for t, i, v, a in zip(*muts):
        if a:
            out[t, i] = v
    return out


def _jax_walk(table, logical, degree):
    return tuple(np.asarray(x) for x in
                 jax_pte_ref(jnp.asarray(table), jnp.asarray(logical), degree))


@pytest.mark.parametrize("epb,degree", [(64, 0), (64, 3), (512, 0), (512, 3),
                                        (512, 9)])
@pytest.mark.parametrize("masked", [False, True])
def test_torch_fused_walk_matches_jax_composition(epb, degree, masked):
    """apply_mutations then pte_gather_ref in JAX against the one fused call,
    bit-exact.  Slots are distinct and the JAX version's dummy slot (the last
    entry, where it routes entries not applied) is never named: the order of
    its duplicates is queue 3's difference, not this test's."""
    rng = np.random.default_rng(epb + degree)
    T, n, M = 4096 // epb, 300, 64
    entries = _entries(rng, T, epb)
    slots = rng.permutation(T * epb - 1)[:n]
    applied = rng.random(n) > 0.3 if masked else np.ones(n, bool)
    muts = _mutations(slots, epb, _values(rng, n), applied)
    logical = rng.integers(-2, T * epb + 2, M).astype(np.int32)
    logical[:8] = slots[:8]                      # walk some mutated slots
    got = _fused(entries, logical, degree, muts)
    table = np.asarray(jbt.apply_mutations(*(jnp.asarray(a) for a in (entries, *muts))))
    np.testing.assert_array_equal(got[3], table)
    for g, w in zip(got[:3], _jax_walk(table, logical, degree)):
        np.testing.assert_array_equal(g, w)
    assert got[2].shape == (M, 1 << degree) and got[1].dtype == bool
    assert pte_gather.launches == 0              # CPU tensors: plain version


def test_torch_fused_walk_rejects_a_window_wider_than_a_page():
    rng = np.random.default_rng(0)
    entries, logical = _entries(rng, 8, 64), np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="wider than a table page"):
        _fused(entries, logical, 9, None)


@pytest.mark.parametrize("n", [40, 1500, 5000])
def test_torch_fused_walk_last_applied_mutation_wins(n):
    """Slots named many times, across the kernel's 1 024-mutation chunks too:
    the table ends as the mutations applied one by one in program order."""
    rng = np.random.default_rng(n)
    T, epb = 4, 64
    entries = _entries(rng, T, epb)
    slots = rng.integers(0, 40, n)               # 40 slots: many duplicates
    muts = _mutations(slots, epb, _values(rng, n), rng.random(n) > 0.25)
    logical = np.arange(-1, 48, dtype=np.int32)
    got = _fused(entries, logical, 3, muts)
    table = _sequential(entries, muts)
    np.testing.assert_array_equal(got[3], table)
    for g, w in zip(got[:3], _jax_walk(table, logical, 3)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("where", ["first", "last", "all"])
def test_torch_fused_walk_entries_not_applied_are_inert(where):
    """An entry not applied writes nothing, even where it names a live slot,
    comes after an applied one, or is all there is."""
    rng = np.random.default_rng(1)
    entries = _entries(rng, 2, 64)
    live = np.flatnonzero(entries.reshape(-1) >= 0)[:3]
    slots = np.array([live[0], live[0], live[1], live[2]])
    values = np.array([7, 8, 9, 10], np.int32)
    applied = {"first": [False, True, True, True],
               "last": [True, False, True, False],
               "all": [False] * 4}[where]
    muts = _mutations(slots, 64, values, np.array(applied))
    got = _fused(entries, live.astype(np.int32), 0, muts)
    want = _sequential(entries, muts)
    np.testing.assert_array_equal(got[3], want)
    if where == "all":
        np.testing.assert_array_equal(got[3], entries)
    np.testing.assert_array_equal(got[2][:, 0], want.reshape(-1)[live])


@pytest.mark.parametrize("n_drains", [2, 3, 5])
def test_torch_drains_concatenated_equal_drains_applied_in_turn(n_drains):
    """One call with several drains concatenated in order gives the table and
    walk that the drains give applied one call after another — the manager
    stages every pending drain into one call."""
    rng = np.random.default_rng(n_drains)
    T, epb = 8, 64
    entries = _entries(rng, T, epb)
    drains = []
    for _ in range(n_drains):
        k = int(rng.integers(1, 400))
        slots = rng.integers(0, 100, k)          # duplicates across drains
        drains.append(_mutations(slots, epb, _values(rng, k), rng.random(k) > 0.2))
    logical = rng.integers(-1, 120, 50).astype(np.int32)
    joined = tuple(np.concatenate(col) for col in zip(*drains))
    got = _fused(entries, logical, 3, joined)
    table = entries
    for d in drains:
        table = _fused(table, np.empty(0, np.int32), 3, d)[3]
    want = _fused(table, logical, 3, None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_torch_fused_walk_with_nothing_to_drain_or_walk():
    rng = np.random.default_rng(2)
    T, epb, degree = 4, 64, 2
    entries = _entries(rng, T, epb)
    logical = rng.integers(-2, T * epb + 2, 20).astype(np.int32)
    empty = _mutations(np.empty(0, np.int64), epb, np.empty(0, np.int32),
                       np.empty(0, bool))
    # n_mut = 0: the walk alone, as with no list at all
    for g, w in zip(_fused(entries, logical, degree, empty),
                    _fused(entries, logical, degree, None)):
        np.testing.assert_array_equal(g, w)
    # M = 0: the drain alone
    slots = rng.integers(0, T * epb, 30)
    muts = _mutations(slots, epb, _values(rng, 30), np.ones(30, bool))
    frames, present, window, table = _fused(entries, np.empty(0, np.int32),
                                            degree, muts)
    assert frames.shape == present.shape == (0,) and window.shape == (0, 4)
    np.testing.assert_array_equal(table, _sequential(entries, muts))
    # neither
    frames, _, window, table = _fused(entries, np.empty(0, np.int32), degree, empty)
    assert frames.shape == (0,) and window.shape == (0, 4)
    np.testing.assert_array_equal(table, entries)


@pytest.mark.parametrize("table,idx", [(4, 0), (-1, 0), (0, 64), (0, -1)])
def test_torch_fused_walk_rejects_a_slot_outside_the_table(table, idx):
    entries = np.full((4, 64), -1, np.int32)
    muts = (np.array([0, table], np.int32), np.array([1, idx], np.int32),
            np.array([5, 6], np.int32), np.array([True, False]))
    with pytest.raises(RuntimeError):
        _fused(entries, np.arange(3, dtype=np.int32), 0, muts)


def test_torch_fused_walk_rejects_malformed_mutations():
    entries = torch.full((4, 64), -1, dtype=torch.int32)
    logical = torch.arange(3, dtype=torch.int32)
    ok = (torch.zeros(2, dtype=torch.int32),) * 3 + (torch.ones(2, dtype=torch.bool),)
    for bad in [ok[:3], ok[:3] + (ok[3].to(torch.uint8),),
                (ok[0][:1],) + ok[1:], ok[:2] + (ok[2].long(), ok[3])]:
        with pytest.raises(TypeError):
            pte_gather(entries, logical, 0, bad)


# --------------------------------------------------------------- the manager
def _both_kv(mode, budget):
    args = dict(n_frames=336, block_tokens=4, max_blocks_per_seq=21, n_pods=4)
    port = PagedKVManager(mode=CoherenceMode(mode), device="cpu", **args)
    port.host.spec = dataclasses.replace(port.host.spec, mutation_budget=budget)
    return port, JaxKV(mode=jbt.CoherenceMode(mode), **args)


def _host_walk(kv, ids):
    """The walk on the host's canonical table, in numpy."""
    logical = kv.logical_tables(ids)
    epb = kv.spec.entries_per_table
    raw = kv.host.canonical[np.maximum(logical, 0) // epb, np.maximum(logical, 0) % epb]
    return np.where((logical >= 0) & (raw >= 0), raw & ((1 << 28) - 1), -1)


@pytest.mark.parametrize("mode", ["local", "eager", "numapte"])
@pytest.mark.parametrize("budget", [1024, 32])
def test_torch_manager_full_wave_matches_host(mode, budget):
    """Two waves on the CPU — allocation, four extension steps, frees — with
    the JAX manager beside: after every walk the device table equals the
    host's canonical table, and the frames equal the host's walk and the JAX
    manager's.  With a drain budget of 32 a walk stages several drains, and
    the second wave's first walk carries the first wave's frees and the
    allocations that reuse their slots in one list."""
    port, ref = _both_kv(mode, budget)
    batch, prompt, gen = 4, 64, 16
    for wave in range(2):
        ids = [wave * batch + i for i in range(batch - 1)] + [-1]   # a padding row
        for kv in (port, ref):
            for i, sid in enumerate(ids[:-1]):
                kv.start_sequence(sid, prompt, pod=i % 4)
        steps = [("first", {})] + [(t, {"record": t % 4 == 0}) for t in range(gen)]
        extensions = 0
        for t, kw in steps:
            if t != "first":
                for kv in (port, ref):
                    for sid in ids[:-1]:
                        kv.maybe_extend(sid, prompt + t + 1)
                extensions += bool(port.host._pending_mut)
            got = port.physical_tables(ids, **kw).numpy()
            np.testing.assert_array_equal(got, ref.physical_tables(ids, **kw))
            np.testing.assert_array_equal(got, _host_walk(port, ids))
            np.testing.assert_array_equal(port.device_table.numpy(),
                                          port.host.canonical)
        assert extensions == 4
        for kv in (port, ref):
            for sid in ids[:-1]:
                kv.finish_sequence(sid)
        if wave == 0:                # the frees stay pending into wave 1
            assert len(port.host._pending_mut) == 3 * 20
    port.check_device_table()
    assert dataclasses.asdict(port.host.counters) == dataclasses.asdict(ref.host.counters)


def test_torch_manager_walk_is_one_staged_copy_and_one_call(monkeypatch):
    """Whatever the number of pending drains, a walk sends one staging
    buffer and makes one pte_gather call; with nothing pending and no ids it
    makes neither."""
    calls = {"send": 0, "pte_gather": 0}
    send, walk = StagingRing.send, manager_mod.pte_gather

    def counted_send(self, *a, **kw):
        calls["send"] += 1
        return send(self, *a, **kw)

    def counted_walk(*a, **kw):
        calls["pte_gather"] += 1
        return walk(*a, **kw)

    monkeypatch.setattr(StagingRing, "send", counted_send)
    monkeypatch.setattr(manager_mod, "pte_gather", counted_walk)
    kv = PagedKVManager(n_frames=4096, block_tokens=4, max_blocks_per_seq=1100,
                        n_pods=1, device="cpu")
    for sid in range(3):
        kv.start_sequence(sid, prompt_len=4 * 1000, pod=0)
    assert len(kv.host._pending_mut) == 3000           # three drains
    tables = kv.physical_tables([0, 1, 2], record=False).numpy()
    assert calls == {"send": 1, "pte_gather": 1}
    np.testing.assert_array_equal(tables, _host_walk(kv, [0, 1, 2]))
    kv.sync_device_table()                             # nothing pending
    assert calls == {"send": 1, "pte_gather": 1}
    kv.finish_sequence(1)
    kv.check_device_table()                            # M = 0, one call
    assert calls == {"send": 2, "pte_gather": 2}


class _InFlight:
    """Stands in for the CUDA event of a copy that has not completed."""

    def query(self):
        return False


def test_torch_staging_ring_never_overwrites_a_buffer_in_flight():
    ring = StagingRing(torch.device("cpu"), nbytes=16, slots=2)

    def fill(value):
        return lambda buf: buf.__setitem__(slice(None), value)

    out = ring.send(fill(1), 16)
    assert torch.equal(out, torch.full((16,), 1, dtype=torch.uint8))
    first = ring.buffers[0]
    ring.events[0] = _InFlight()                 # its copy may be in flight
    ring.send(fill(2), 8)
    assert ring.buffers[0] is first and int(first[0]) == 1
    assert int(ring.buffers[1][0]) == 2
    ring.events[1] = _InFlight()                 # both in flight: a third
    out = ring.send(fill(3), 40)                 # ... that fits 40 bytes
    assert len(ring.buffers) == 3 and ring.buffers[2].numel() >= 40
    assert torch.equal(out, torch.full((40,), 3, dtype=torch.uint8))
    assert int(first[0]) == 1 and int(ring.buffers[1][0]) == 2
    ring.events[0] = None                        # first copy done: reused,
    ring.send(fill(4), 100)                      # grown to fit
    assert ring.buffers[0] is not first and ring.buffers[0].numel() >= 100
    assert int(ring.buffers[0][99]) == 4
