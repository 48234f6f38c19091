"""The fifo_miss kernel's warp walk, emulated on the CPU.

``csrc/fifo_miss.cu`` walks the stream with one warp, 32 consecutive
accesses a window.  Lane j loads its id and its id's fill number f, finds
its peers (the lanes below it with the same id: ``__match_any_sync``), and
the window's miss flags b settle by rounds: given b, lane j's fill count is
N_j = N + popc(b & lanes below j), its id's fill number F_j is N_i of the
latest earlier peer i that missed, else f, and lane j misses iff
F_j < N_j - capacity; a round recomputes every flag and ballots them, until
the ballot no longer changes.  A window starts from "every lane misses"
when every lane of the window before missed, else from "no lane misses".
Then the last missing lane of each group of equal ids stores its N_j, and
N grows by the window's misses.  In shared memory the kernel finds the
groups through the fill vector itself rather than ``__match_any_sync``.

``warp_walk`` is that warp in numpy: the ballot is a bool vector over the
lanes, the match an equality matrix; with ``shared=True`` the groups come
as the shared-memory instance finds them (lane numbers written into the
fill vector, the winner read back and balloted bit by bit, the entries of
ids with no miss written back), and both instances are checked.  It is held bit for bit against the
plain scan (``fifo_miss_ref``) and the numpy loop on the reference's 25
trials, on ``chipcheck/numa_sim.py:fifo_repeats``-style streams and on adversarial
ones: one id 32 times, capacities 0, 1, 31, 32 and 33, every length mod 32,
and constructed windows that need more than 8 rounds (the rounds are
asserted).  The control stops each window after one round: it must miss on
those windows, or the test could not tell a settled window from a guess.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fifo_miss as port  # noqa: E402

LANES = 32
LANE = np.arange(LANES)
BELOW = LANE[None, :] < LANE[:, None]          # [j, i]: lane i is below j


def tag_groups(fill, id_, active):
    """The shared-memory instance's groups: every active lane writes its
    lane number into its id's entry (one of them wins; numpy keeps the
    last), reads back the winner, and six ballots over the winner's bits
    (lanes past n take 32 + lane) give the lanes with the same winner."""
    fill[id_[active]] = LANE[active]
    owner = np.where(active, fill[np.where(active, id_, 0)], 32 + LANE)
    group = np.ones((LANES, LANES), bool)
    for bit in range(6):
        set_ = (owner >> bit) & 1 == 1                   # the ballot
        group &= set_[:, None] == set_[None, :]
    return group, owner


def warp_walk(fill0, nfill0, ids, capacity, max_rounds=None, shared=False):
    """The kernel's walk: ``(flags [n] bool, rounds of each window)``.
    ``shared`` takes the shared-memory instance's groups (``tag_groups``)
    in place of ``__match_any_sync``.  ``max_rounds`` stops a window's
    rounds early (the control)."""
    fill = np.asarray(fill0, np.int64).copy()
    ids = np.asarray(ids, np.int64)
    n, N = ids.size, int(nfill0)
    flags = np.zeros(n, bool)
    rounds = []
    all_missed = True
    for base in range(0, n, LANES):
        active = base + LANE < n
        id_ = np.full(LANES, -1)                 # lanes past n hold -1
        id_[active] = ids[base:base + LANES]
        f = np.where(active, fill[np.where(active, id_, 0)], 0)
        if shared:
            group, owner = tag_groups(fill, id_, active)
        else:
            group = id_[None, :] == id_[:, None]     # __match_any_sync
        peers = group & BELOW
        b = active.copy() if all_missed else np.zeros(LANES, bool)
        r = 0
        while True:
            r += 1
            before = np.concatenate([[0], np.cumsum(b)[:-1]])   # popc(b & below)
            missed_peers = peers & b[None, :]
            latest = LANES - 1 - np.argmax(missed_peers[:, ::-1], axis=1)
            F = np.where(missed_peers.any(axis=1), N + before[latest], f)
            nb = active & (F < N + before - capacity)            # the ballot
            if np.array_equal(nb, b) or r == max_rounds:
                b = nb
                break
            b = nb
        rounds.append(r)
        before = np.concatenate([[0], np.cumsum(b)[:-1]])
        later_miss = (group & BELOW.T & b[None, :]).any(axis=1)
        store = b & ~later_miss                  # the last writer of each id
        fill[id_[store]] = N + before[store]
        if shared:                               # no miss: the entry back
            back = active & ~(group & b[None, :]).any(axis=1) & (owner == LANE)
            fill[id_[back]] = f[back]
        flags[base:base + LANES] = b[active]
        N += int(b.sum())
        all_missed = np.array_equal(b, active)
    return flags, rounds


def check(arr, init, cap, tag=""):
    """The warp against the plain scan and the numpy loop; returns the
    window rounds and the dense operands."""
    arr = np.asarray(arr, np.int64)
    fill0, n0, ids = port.densify(arr, init, cap)
    got, rounds = warp_walk(fill0, n0, ids, cap)
    want = port.fifo_miss_ref(torch.from_numpy(fill0), n0,
                              torch.from_numpy(ids), cap).numpy()
    np.testing.assert_array_equal(got, want, err_msg=tag)
    np.testing.assert_array_equal(
        got, port.fifo_miss(arr, init, cap, backend="numpy"), err_msg=tag)
    assert all(1 <= r <= LANES + 1 for r in rounds), tag
    got_shared, rounds_shared = warp_walk(fill0, n0, ids, cap, shared=True)
    np.testing.assert_array_equal(got_shared, want, err_msg=tag + " (shared)")
    assert rounds_shared == rounds, tag
    return rounds, (fill0, n0, ids)


def reference_trials():
    rng = np.random.default_rng(2024)
    for _ in range(25):
        cap = int(rng.integers(1, 64))
        n0 = int(rng.integers(0, cap + 1))
        init = rng.permutation(500)[:n0].astype(np.int64).tolist()
        arr = rng.integers(0, 1 + int(rng.integers(1, 120)),
                           size=int(rng.integers(0, 300))).astype(np.int64)
        yield arr, init, cap


def test_torch_fifo_window_reference_trials():
    for k, case in enumerate(reference_trials()):
        check(*case, tag=f"trial {k}")


def test_torch_fifo_window_repeats():
    """``chipcheck/numa_sim.py:fifo_repeats``: a handful of vpns, capacities 0-4."""
    rng = np.random.default_rng(3)
    for k in range(200):
        cap = int(rng.integers(0, 5))
        init = rng.permutation(10)[:int(rng.integers(0, cap + 1))].tolist()
        arr = rng.integers(0, int(rng.integers(1, 7)),
                           size=int(rng.integers(0, 41))).astype(np.int64)
        check(arr, init, cap, f"repeat {k}")


@pytest.mark.parametrize("cap", [0, 1, 2, 31, 32, 33])
def test_torch_fifo_window_one_id_32_times(cap):
    """Every lane of a window is every other lane's peer: one miss, then
    hits (at capacity 0 every access misses), cold and warm."""
    for init in ([], [7], [3, 7, 9][:max(cap, 1)]):
        rounds, _ = check([7] * 32 + [7] * 5, init, cap, f"cap {cap} {init}")
        assert len(rounds) == 2


@pytest.mark.parametrize("cap", [0, 1, 31, 32, 33])
def test_torch_fifo_window_capacities(cap):
    """Capacities around the window's width, over alphabets from a few vpns
    (peers in every window) to many (mostly cold), warm and cold TLBs."""
    rng = np.random.default_rng(100 + cap)
    for k in range(12):
        alphabet = int(rng.choice([2, 5, 40, 100, 1000]))
        init = rng.permutation(alphabet + 50)[:int(rng.integers(0, cap + 1))]
        arr = rng.integers(0, alphabet, int(rng.integers(1, 400)))
        check(arr, init.tolist(), cap, f"cap {cap} case {k}")


def test_torch_fifo_window_every_length_mod_32():
    """Lengths 96..127: the last window leaves every remainder, and its
    lanes past n take no part."""
    rng = np.random.default_rng(5)
    for r in range(LANES):
        arr = rng.integers(0, 60, 3 * LANES + r)
        init = rng.permutation(60)[:20].tolist()
        rounds, _ = check(arr, init, 24, f"n = 96 + {r}")
        assert len(rounds) == 3 + (r > 0)


def sweep_of_the_oldest(cap=40):
    """A warm, full TLB (fill numbers 0..cap-1); window 0 hits the newest
    entry 32 times, so window 1 starts from "no lane misses"; window 1 is a
    cold vpn and then the 31 oldest entries in fill order: each miss evicts
    the entry the next lane reads, so the truth is 32 misses, and each round
    makes one more lane miss."""
    init = list(range(1000, 1000 + cap))
    arr = [init[-1]] * LANES + [5] + init[:LANES - 1]
    return np.asarray(arr, np.int64), init, cap


# A window over three vpns with peers on every lane, which needs 19 rounds
# from "every lane misses" (found by a seeded search over small alphabets):
# flipping one lane's flag moves its later peers' F_j and the fill counts of
# every lane above it.
PEER_WINDOW = dict(arr=[0, 2, 2, 0, 2, 1, 0, 2, 1, 0, 0, 1, 2, 0, 1, 1,
                        0, 1, 0, 1, 2, 1, 2, 0, 0, 1, 1, 2, 0, 0, 0, 2],
                   init=[1], cap=2)


def test_torch_fifo_window_rounds_past_8():
    arr, init, cap = sweep_of_the_oldest()
    rounds, _ = check(arr, init, cap, "sweep of the oldest")
    assert rounds == [2, LANES + 1]
    flags = port.fifo_miss(arr, init, cap, backend="numpy")
    assert not flags[:LANES].any() and flags[LANES:].all()
    rounds, _ = check(**PEER_WINDOW, tag="peer window")
    assert rounds == [19]


def test_torch_fifo_window_one_round_is_not_enough():
    """The control: the same warp stopped after one round a window differs
    from the sequential walk on both constructed streams."""
    for arr, init, cap in (sweep_of_the_oldest(),
                           tuple(PEER_WINDOW.values())):
        arr = np.asarray(arr, np.int64)
        fill0, n0, ids = port.densify(arr, init, cap)
        want = port.fifo_miss(arr, init, cap, backend="numpy")
        for shared in (False, True):
            cut, _ = warp_walk(fill0, n0, ids, cap, max_rounds=1, shared=shared)
            assert (cut != want).sum() > 0
            full, _ = warp_walk(fill0, n0, ids, cap, shared=shared)
            np.testing.assert_array_equal(full, want)
