"""The port's FIFO-TLB miss scan against the reference's, bit for bit.

``repro_torch.kernels.fifo_miss`` gives the batched access engine its pass
1: the ``"numpy"`` dict loop, and on the card a CUDA kernel over densified
ids whose plain version (``ref.py``) runs here.  Both must give exactly the
reference's flags (``repro.kernels.fifo_miss`` with its ``"numpy"`` and
``"jit"`` backends).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import fifo_miss as reference  # noqa: E402
from repro_torch.kernels import fifo_miss as port  # noqa: E402


CPU = torch.device("cpu")


def through_ids(fill0, n0, ids, capacity):
    launches = port.fifo_miss_ids.launches
    got = port.fifo_miss_ids(fill0, n0, ids, capacity)
    assert port.fifo_miss_ids.launches == launches      # no kernel on the CPU
    assert got.dtype == torch.bool and got.device.type == "cpu"
    return got.numpy()


def plain(arr, initial, capacity):
    """The port's plain scan over ``densify``'s ids (the TLB's keys and the
    stream sorted together), through the tensor entry point on the CPU."""
    fill0, n0, ids = port.densify(np.asarray(arr, np.int64), initial, capacity)
    return through_ids(torch.from_numpy(fill0), n0, torch.from_numpy(ids),
                       capacity)


def plain_dense(arr, initial, capacity):
    """The ``"cuda"`` backend's front end as the batch engine calls it (the
    caller's ``np.unique`` ids, the TLB mapped in by ``searchsorted``, one
    staging buffer), then the plain scan on the CPU."""
    arr = np.asarray(arr, np.int64)
    dense = np.unique(arr, return_inverse=True)
    return through_ids(*port.stage(arr, initial, capacity, dense=dense,
                                   device=CPU), capacity)


def assert_all_agree(arr, initial, capacity, tag="", jit=True):
    arr = np.asarray(arr, dtype=np.int64)
    want = reference.fifo_miss(arr, initial, capacity, backend="numpy")
    others = [port.fifo_miss(arr, initial, capacity, backend="numpy"),
              plain(arr, initial, capacity),
              plain_dense(arr, initial, capacity)]
    if jit:
        others.append(reference.fifo_miss(arr, initial, capacity, backend="jit"))
    for got in others:
        assert got.dtype == bool and got.shape == arr.shape, tag
        np.testing.assert_array_equal(got, want, err_msg=tag)
    return want


def trials():
    """The reference's 25 random streams, capacities and warm TLBs."""
    rng = np.random.default_rng(2024)
    for trial in range(25):
        cap = int(rng.integers(1, 64))
        n0 = int(rng.integers(0, cap + 1))
        init = rng.permutation(500)[:n0].astype(np.int64).tolist()
        arr = rng.integers(0, 1 + int(rng.integers(1, 120)),
                           size=int(rng.integers(0, 300))).astype(np.int64)
        yield trial, arr, init, cap


@pytest.mark.parametrize("trial", range(25))
def test_torch_fifo_miss_trials_equal_reference(trial):
    _, arr, init, cap = list(trials())[trial]
    assert_all_agree(arr, init, cap, f"trial {trial} cap={cap}")


def test_torch_fifo_miss_edge_cases():
    # capacity 1: every change of vpn misses
    got = assert_all_agree([5, 5, 6, 5, 6, 6], [5], 1, "capacity 1")
    assert got.tolist() == [False, False, True, True, True, False]
    # an empty stream, cold and warm (the reference's jit backend raises on
    # the cold one: it indexes a fill vector of no ids)
    assert assert_all_agree([], [], 4, "empty", jit=False).size == 0
    assert assert_all_agree([], [1, 2], 4, "empty warm").size == 0
    # a full TLB (n0 == capacity): its entries hit, a new vpn evicts the oldest
    got = assert_all_agree([1, 2, 3, 9, 1, 2], [1, 2, 3], 3, "n0 == capacity")
    assert got.tolist() == [False, False, False, True, True, True]
    # one vpn, many times: one miss
    got = assert_all_agree([7] * 50, [], 8, "one vpn")
    assert got.sum() == 1 and got[0]
    # miss, evicted, miss again: a vpn's second fill restarts its lifetime
    got = assert_all_agree([1, 2, 3, 1, 4, 1], [], 2, "refill")
    assert got.tolist() == [True, True, True, True, True, False]


def test_torch_fifo_miss_repeated_ids():
    """Streams over a handful of vpns, capacities 0-4: the same vpn recurs
    within a few accesses (the card's kernel takes 32 ids a window)."""
    rng = np.random.default_rng(3)
    for trial in range(200):
        cap = int(rng.integers(0, 5))
        init = rng.permutation(10)[:int(rng.integers(0, cap + 1))].tolist()
        arr = rng.integers(0, int(rng.integers(1, 7)),
                           size=int(rng.integers(0, 41))).astype(np.int64)
        assert_all_agree(arr, init, cap, f"repeat {trial} cap={cap}", jit=False)


def test_torch_fifo_miss_engine_sized_stream():
    """A stream of the batch engine's call shape at a tenth of its size: a
    warm TLB, most accesses over a wide range of vpns."""
    rng = np.random.default_rng(7)
    init = rng.permutation(1 << 20)[:1088].tolist()
    arr = np.concatenate([rng.integers(0, 1 << 20, 3000),
                          rng.choice(init, 1000)]).astype(np.int64)
    rng.shuffle(arr)
    got = assert_all_agree(arr, init, 1088, "engine shape")
    assert 0 < got.sum() < arr.size


def test_torch_fifo_miss_refusals(monkeypatch):
    arr = np.arange(10, dtype=np.int64)
    with pytest.raises(ValueError, match="cuda"):
        port.fifo_miss(arr, [], 4, backend="jit")
    monkeypatch.setenv("REPRO_FIFO_MISS_BACKEND", "jit")
    with pytest.raises(ValueError, match="numpy"):
        port.fifo_miss(arr, [], 4)
    monkeypatch.delenv("REPRO_FIFO_MISS_BACKEND")
    # the card is the default, and without one the call raises: no fallback
    assert port.default_backend() == "cuda" and port.BACKENDS == ("numpy", "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.fifo_miss(arr, [], 4)
        with pytest.raises(RuntimeError, match="CUDA"):
            port.fifo_miss(arr, [], 4, backend="cuda",
                           dense=np.unique(arr, return_inverse=True))
        monkeypatch.setenv("REPRO_FIFO_MISS_BACKEND", "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            port.fifo_miss(arr, [], 4)
    monkeypatch.setenv("REPRO_FIFO_MISS_BACKEND", "numpy")
    assert port.default_backend() == "numpy"
    # dense ids of another stream are refused
    with pytest.raises(ValueError, match="dense ids"):
        port.stage(arr, [], 4, dense=np.unique(arr[:5], return_inverse=True),
                   device=CPU)
    # int32 arithmetic: a fill count that could reach 2^31 is refused
    ids = torch.zeros(10, dtype=torch.int32)
    fill0 = torch.full((1,), -5, dtype=torch.int32)
    with pytest.raises(OverflowError):
        port.fifo_miss_ids(fill0, (1 << 31) - 10, ids, 4)
    assert port.fifo_miss_ids(fill0, (1 << 31) - 11, ids, 4).sum() == 1
    with pytest.raises(OverflowError):
        port.fifo_miss_ids(fill0, 0, ids, (1 << 31) - 1)
    with pytest.raises(TypeError):
        port.fifo_miss_ids(fill0.long(), 0, ids, 4)
    with pytest.raises(IndexError):
        port.fifo_miss_ids(fill0, 0, ids + 1, 4)


FRONT_END_CASES = {
    # name: (stream, TLB in fill order, capacity)
    "entries absent from the stream": ([40, 3, 40, 7, 3, 9, 1, 40],
                                       [100, 3, 55, 9, 200], 6),
    "empty TLB": ([4, 4, 2, 8, 2, 4, 16, 8], [], 3),
    "empty stream": ([], [5, 6, 7], 4),
    "empty stream, empty TLB": ([], [], 4),
    "full TLB": ([1, 2, 3, 9, 1, 2, 30, 3], [30, 1, 2, 3], 4),
    "full TLB, none in the stream": ([8, 9, 8, 10], [1, 2, 3], 3),
}


@pytest.mark.parametrize("case", sorted(FRONT_END_CASES))
def test_torch_fifo_miss_dense_front_end(case):
    """``stage`` with the caller's ``np.unique`` ids gives what ``densify``
    gives, access for access: the same vpn behind each id, the same seed
    fill number, the same fill count; and through the plain scan the same
    flags as the reference."""
    arr, init, cap = FRONT_END_CASES[case]
    arr = np.asarray(arr, np.int64)
    uniq, inv = np.unique(arr, return_inverse=True)
    fill0, n0, ids = port.stage(arr, init, cap, dense=(uniq, inv), device=CPU)
    assert fill0.dtype == ids.dtype == torch.int32
    assert fill0.shape == uniq.shape and ids.shape == arr.shape
    s_fill0, s_n0, s_ids = port.densify(arr, init, cap)
    assert n0 == s_n0 == len(init)
    np.testing.assert_array_equal(uniq[ids.numpy()], arr)
    np.testing.assert_array_equal(fill0.numpy()[ids.numpy()], s_fill0[s_ids])
    # an id holds its entry's fill order, or the sentinel when the TLB
    # lacks it; entries the stream never reads take no id
    order = {v: p for p, v in enumerate(init)}
    np.testing.assert_array_equal(
        fill0.numpy(), [order.get(int(v), -(cap + 1)) for v in uniq])
    np.testing.assert_array_equal(port.seed_fill(uniq, init, cap)[0],
                                  fill0.numpy())
    assert_all_agree(arr, init, cap, case, jit=arr.size > 0 or bool(init))


def test_torch_fifo_miss_kernel_source_is_built_for_hopper():
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fifo_miss.cu").read_text()
    assert "src/repro/kernels/fifo_miss.py" in src
    assert 'extern "C" int fifo_miss_launch' in src
    assert "__match_any_sync" in src and "__ballot_sync" in src
    assert "fifo_miss" in _build.KERNELS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
