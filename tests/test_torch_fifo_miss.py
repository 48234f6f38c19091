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


def plain(arr, initial, capacity):
    """The port's plain scan, through the tensor entry point on the CPU."""
    fill0, n0, ids = port.densify(np.asarray(arr, np.int64), initial, capacity)
    launches = port.fifo_miss_ids.launches
    got = port.fifo_miss_ids(torch.from_numpy(fill0), n0,
                             torch.from_numpy(ids), capacity)
    assert port.fifo_miss_ids.launches == launches      # no kernel on the CPU
    assert got.dtype == torch.bool and got.device.type == "cpu"
    return got.numpy()


def assert_all_agree(arr, initial, capacity, tag="", jit=True):
    arr = np.asarray(arr, dtype=np.int64)
    want = reference.fifo_miss(arr, initial, capacity, backend="numpy")
    others = [port.fifo_miss(arr, initial, capacity, backend="numpy"),
              plain(arr, initial, capacity)]
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
    within a few accesses (the card's kernel takes ids four at a time)."""
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
    assert port.default_backend() == "numpy" and port.BACKENDS == ("numpy", "cuda")
    if not torch.cuda.is_available():     # no fallback to numpy
        with pytest.raises(RuntimeError, match="CUDA"):
            port.fifo_miss(arr, [], 4, backend="cuda")
        monkeypatch.setenv("REPRO_FIFO_MISS_BACKEND", "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            port.fifo_miss(arr, [], 4)
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


def test_torch_fifo_miss_kernel_source_is_built_for_hopper():
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fifo_miss.cu").read_text()
    assert "src/repro/kernels/fifo_miss.py" in src
    assert 'extern "C" int fifo_miss_launch' in src
    assert "fifo_miss" in _build.KERNELS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
