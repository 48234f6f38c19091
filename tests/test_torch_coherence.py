"""The port's coherence collectives (``repro_torch.pagedpt.coherence``) over
``LoopPods`` against the reference's ``shard_map`` bodies run under
``jax.vmap(..., axis_name="pod")`` on the same stacked numpy inputs:
replicas, sharer masks and scopes bit-exact.  Then the manager's invariant:
a 4-pod ``PagedKVManager`` driven through alloc, extend, record and free,
its drained buffers fed to the prologue, holds every replica against the
host's ``present`` / ``canonical`` and ``shootdown_scope`` against the
host's invalidation targets."""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.pagedpt import coherence as jcoh  # noqa: E402
from repro_torch.distributed import LoopPods  # noqa: E402
from repro_torch.kvcache import PagedKVManager  # noqa: E402
from repro_torch.pagedpt import coherence as coh  # noqa: E402
from repro_torch.pagedpt.blocktable import CoherenceMode  # noqa: E402

T, EPB, B, M, DEGREE = 8, 32, 24, 6, 2


def _entries(rng, P):
    e = rng.integers(0, 1 << 20, (P, T, EPB)).astype(np.int32) | (3 << 28)
    e[rng.random(e.shape) < 0.4] = -1
    return e


def _mutations(rng, P, n=B):
    """Per-pod buffers [P, n]: slots unique across all pods and clear of the
    reference's dummy slot (its write-back there races, ROADMAP queue 3), a
    third not applied."""
    slots = rng.permutation(T * EPB - 1)[:P * n].reshape(P, n)
    value = (rng.integers(0, 1 << 20, (P, n)) | (3 << 28)).astype(np.int32)
    value[rng.random((P, n)) < 0.3] = -1
    return ((slots // EPB).astype(np.int32), (slots % EPB).astype(np.int32),
            value, rng.random((P, n)) > 0.33)


def _sharers(rng, P):
    return rng.integers(0, 1 << P, T).astype(np.uint32)


def _misses(rng, P):
    miss = rng.integers(0, T * EPB, (P, M)).astype(np.int32)
    miss[rng.random((P, M)) < 0.3] = -1
    miss[0, 0] = T * EPB + 5          # past the table: the tid clips
    return miss


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a.copy())


def _vmapped(fn, *args, in_axes):
    return jax.vmap(fn, in_axes=in_axes, axis_name="pod")(
        *(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("P", [2, 4])
def test_torch_eager_sync_matches_jax(P):
    rng = np.random.default_rng(P)
    entries, muts = _entries(rng, P), _mutations(rng, P)
    want = _vmapped(functools.partial(jcoh.eager_sync, axis_name="pod"),
                    entries, *muts, in_axes=0)
    local = _t(entries)
    got = coh.eager_sync(local, *map(_t, muts), pods=LoopPods(P, "cpu"))
    assert got is local
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("P", [2, 4])
def test_torch_sharer_filter_and_scope_match_jax(P):
    rng = np.random.default_rng(10 + P)
    sharers = _sharers(rng, P)
    t, _, _, ok = _mutations(rng, P)
    t[0, :3] = [-1, T, 2 * T]         # ids past either end clip, as the reference
    want = _vmapped(functools.partial(jcoh.sharer_filter_mask, axis_name="pod"),
                    sharers, t, ok, in_axes=(None, 0, 0))
    got = coh.sharer_filter_mask(_t(sharers), _t(t), _t(ok), LoopPods(P, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for p in range(P):
        scope = jcoh.shootdown_scope(jnp.asarray(sharers), jnp.asarray(t[p]),
                                     jnp.asarray(ok[p]))
        assert int(coh.shootdown_scope(_t(sharers), _t(t[p]), _t(ok[p]))) == \
            int(scope)


@pytest.mark.parametrize("P", [2, 4])
def test_torch_numapte_apply_filtered_matches_jax(P):
    rng = np.random.default_rng(20 + P)
    entries, muts, sharers = _entries(rng, P), _mutations(rng, P), _sharers(rng, P)
    want = _vmapped(lambda loc, s, *m: jcoh.numapte_apply_filtered(
        loc, s, *m, axis_name="pod"), entries, sharers, *muts,
        in_axes=(0, None, 0, 0, 0, 0))
    got = coh.numapte_apply_filtered(_t(entries), _t(sharers), *map(_t, muts),
                                     pods=LoopPods(P, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _miss_case(rng, P):
    entries, sharers = _entries(rng, P), _sharers(rng, P)
    owner = rng.integers(0, P, T).astype(np.int32)
    return entries, sharers, owner, _misses(rng, P)


@pytest.mark.parametrize("P", [2, 4])
def test_torch_numapte_miss_fetch_matches_jax(P):
    rng = np.random.default_rng(30 + P)
    entries, sharers, owner, miss = _miss_case(rng, P)
    want_e, want_s = _vmapped(lambda loc, s, o, m: jcoh.numapte_miss_fetch(
        loc, s, o, m, DEGREE, axis_name="pod"), entries, sharers, owner, miss,
        in_axes=(0, None, None, 0))
    got_e, got_s = coh.numapte_miss_fetch(_t(entries), _t(sharers), _t(owner),
                                          _t(miss), DEGREE, LoopPods(P, "cpu"))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    for p in range(P):
        np.testing.assert_array_equal(got_s.numpy(),
                                      np.asarray(want_s[p]).astype(np.int64))


@pytest.mark.parametrize("P", [2, 4])
def test_torch_numapte_prologue_is_filtered_apply_then_fetch(P):
    """The fused two-launch prologue equals the reference's two calls."""
    rng = np.random.default_rng(40 + P)
    entries, sharers, owner, miss = _miss_case(rng, P)
    muts = _mutations(rng, P)

    def ref(loc, s, o, t, i, v, ok, m):
        loc = jcoh.numapte_apply_filtered(loc, s, t, i, v, ok, axis_name="pod")
        return jcoh.numapte_miss_fetch(loc, s, o, m, DEGREE, axis_name="pod")

    want_e, want_s = _vmapped(ref, entries, sharers, owner, *muts, miss,
                              in_axes=(0, None, None, 0, 0, 0, 0, 0))
    pods = LoopPods(P, "cpu")
    got_e, got_s = coh.numapte_prologue(_t(entries), _t(sharers), _t(owner),
                                        *map(_t, muts), _t(miss), DEGREE, pods)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.asarray(want_s[0]).astype(np.int64))
    # the collectives of one prologue: the 4 mutation buffers and the miss
    # buffer gathered, the answers routed back, the sharer bits summed
    assert pods.calls == {"all_gather": 5, "all_to_all": 1, "psum": 1}
    per_pod = (P - 1) * (B * 13 + M * 4 + M * (1 << DEGREE) * 4 + T * 4)
    assert pods.wire_bytes == P * per_pod


def test_torch_coherence_rejects_a_slot_outside_the_table():
    """A mutation naming a slot outside its replica is refused (the
    reference's flat index would write the next table, ROADMAP queue 3),
    applied or not; stacking must not let it land in the next replica."""
    rng = np.random.default_rng(7)
    for bad in ([T, 0], [0, EPB], [-1, 0]):
        t, i, v, ok = _mutations(rng, 2)
        t[1, 3], i[1, 3] = bad
        ok[1, 3] = False
        with pytest.raises(RuntimeError):
            coh.eager_sync(_t(_entries(rng, 2)), _t(t), _t(i), _t(v), _t(ok),
                           pods=LoopPods(2, "cpu"))


# ------------------------------------------------------ manager invariant
def _prologue(kv, mode, pods):
    """Deliver everything the manager queued to the replicas (rounds of the
    per-step budgets); returns the rounds it took."""
    rounds = 0
    while kv.coherence_pending():
        sharers, owner, *muts, miss = kv.coherence_inputs(
            mutation_budget=4, miss_budget=2)
        if mode == "eager":
            coh.eager_sync(kv.replicas, *muts, pods=pods)
        else:
            _, new = coh.numapte_prologue(kv.replicas, sharers, owner, *muts,
                                          miss, kv.spec.prefetch_degree, pods)
            # the host already holds the requesters' bits
            np.testing.assert_array_equal(new.numpy(), kv.host.sharers)
        rounds += 1
    return rounds


@pytest.mark.parametrize("mode", ["eager", "numapte"])
def test_torch_manager_replicas_follow_the_host(mode):
    """Alloc, extend, record and free over waves, sequences homed on pods
    1-3 so the scheduler pod 0 misses their tails; after each step's
    prologue every numaPTE replica equals the canonical table wherever the
    host says the pod holds the entry (an eager replica: everywhere), and
    each free's ``shootdown_scope`` is the host's invalidation target set."""
    P, bt = 4, 4
    kv = PagedKVManager(n_frames=256, block_tokens=bt, max_blocks_per_seq=10,
                        n_pods=P, mode=CoherenceMode(mode), entries_per_table=16,
                        prefetch_degree=2, n_pools=P, replicas=True,
                        device="cpu")
    pods = LoopPods(P, "cpu")
    rng = np.random.default_rng(0)
    sid, most = 0, 0
    for wave in range(3):
        rows = list(range(sid, sid + 4))
        sid += 4
        lens = {s: int(rng.integers(3, 18)) for s in rows}
        for r, s in enumerate(rows):
            kv.start_sequence(s, lens[s], pod=(r + wave) % P)
        for step in range(8):
            for s in rows:
                lens[s] += 1
                kv.maybe_extend(s, lens[s])
            kv.physical_tables(rows, record=step % 3 == 0)
            most = max(most, _prologue(kv, mode, pods))
            assert kv.replica_mismatches(full=mode == "eager") == 0
            kv.host.check_invariants()
        for s in rows:
            # the free's mutations touch the sequence's tables: their scope
            # is the pods the host sends the invalidation to
            blocks = kv.host.seqs[s].logical_blocks
            tables = torch.tensor(sorted({b // 16 for b in blocks}))
            scope = int(coh.shootdown_scope(torch.from_numpy(
                kv.host.sharers.astype(np.int64)), tables,
                torch.ones_like(tables, dtype=torch.bool)))
            before = kv.host.counters.invalidations_sent
            kv.finish_sequence(s)
            sent = kv.host.counters.invalidations_sent - before
            assert sent == (bin(scope).count("1") if mode == "numapte" else P)
        kv.sync_device_table()
        most = max(most, _prologue(kv, mode, pods))
        assert kv.replica_mismatches(full=mode == "eager") == 0
    assert most > 1            # a wave switch outgrew one round's budgets
    if mode == "numapte":
        assert kv.host.counters.fetches > 0


@pytest.mark.parametrize("mode", ["eager", "numapte"])
def test_torch_coherence_rounds_drain_a_wave_switch(mode):
    """A wave switch (a wave's frees and the next wave's allocations, 8 256
    mutations) outgrows one step's budgets of 4 x 1 024: ``coherence_rounds``
    runs a timed round after round until nothing is pending, every replica
    then agrees with the host, and it returns the K3 launches it made."""
    from repro_torch.kernels.pte_gather import pte_gather
    from repro_torch.launch import specs
    P, B, S, bt = 4, 32, 2048, 16
    mb = S // bt + 1
    kv = PagedKVManager(n_frames=2 * B * mb, block_tokens=bt,
                        max_blocks_per_seq=mb, n_pods=P,
                        mode=CoherenceMode(mode), n_pools=P, replicas=True,
                        device="cpu")
    pods = LoopPods(P, "cpu")
    for wave in range(2):
        rows = list(range(B * wave, B * (wave + 1)))
        for r in rows:
            kv.start_sequence(r, S, pod=r % B // (B // P))
        kv.physical_tables(rows)
        before, timer = pte_gather.launches, []
        launched = specs.coherence_rounds(mode, pods, kv, timer)
        assert not kv.coherence_pending()
        assert launched == pte_gather.launches - before
        assert kv.replica_mismatches(full=mode == "eager") == 0
        for r in rows:
            kv.maybe_extend(r, S + 1)
            kv.finish_sequence(r)
    assert len(timer) > 1          # the switch took more than one round
