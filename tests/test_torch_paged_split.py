"""The split-KV plan of the paged-attention kernel and its combine rule.

``_split_plan`` is the shape-only arithmetic that decides the kernel's grid;
``paged_attention_split_ref`` repeats the kernel's per-split softmax states
and their merge in plain PyTorch.  Both are checked here on the CPU against
the plain version and the JAX package's Pallas kernel (interpret mode).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ops import paged_attention as jax_paged  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    GROUP, MAX_COLS, MAX_SPLITS, _split_plan, _window_span)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_split_ref)

# one wave of the bf16 head_dim-128 kernel on an H100: 132 SMs, two blocks an
# SM (106 KB of shared memory each)
H100_SLOTS = 132 * 2
# (B, K, G, MB, bt, window): the serving path (Qwen3-14B, batch 16, 69
# columns), one long sequence at Qwen3-14B widths with and without a window,
# more query heads a kv head than one group holds, and the small test shapes
PLANS = [
    (16, 8, 5, 69, 16, None), (1, 8, 5, 2048, 16, None),
    (1, 8, 5, 2048, 16, 4096), (2, 2, 20, 16, 16, None),
    (2, 2, 8, 8, 16, None), (1, 1, 4, 4, 4, None), (2, 2, 8, 16, 8, 24),
    (3, 4, 1, 4, 16, None), (1, 1, 1, 1, 16, None), (4, 8, 5, 100, 1, 7),
    (1, 8, 5, 20000, 16, None), (64, 8, 5, 20000, 16, None),   # long tables
]


def _split_columns(n_splits, cps, MB, bt, seq_len, window):
    """The block-table columns [begin, end) of each split of a row of length
    ``seq_len``, as csrc/paged_attention.cu computes them: the ranges start
    at the window's first column (column 0 without a window) and stop at
    MB.  The kernel's own ranges are held to the plain version on the card
    (chipcheck/kernels.py)."""
    lo = max(seq_len - window, 0) if window is not None else 0
    base = lo // bt
    return [(base + s * cps, min(base + (s + 1) * cps, MB))
            for s in range(n_splits)]


@pytest.mark.parametrize("B,K,G,MB,bt,window", PLANS)
def test_torch_split_plan_covers_every_live_column_once(B, K, G, MB, bt, window):
    n_gc, n_splits, cps = _split_plan(B, K, G, MB, bt, window, H100_SLOTS)
    assert n_gc * GROUP >= G > (n_gc - 1) * GROUP
    assert 1 <= n_splits <= min(MB, MAX_SPLITS) and 1 <= cps <= MAX_COLS
    for seq_len in sorted({0, 1, bt - 1, bt, bt + 1, MB * bt // 2 + 3,
                           MB * bt - 1, MB * bt}):
        ranges = _split_columns(n_splits, cps, MB, bt, seq_len, window)
        cols = [c for lo, hi in ranges for c in range(lo, hi)]
        assert len(cols) == len(set(cols)), "a column in two splits"
        assert all(0 <= c < MB for c in cols), "a column past the table"
        lo = max(seq_len - window, 0) if window is not None else 0
        live = set(range(lo // bt, min(MB, -(-seq_len // bt))))
        assert live <= set(cols), f"live columns missed at seq_len {seq_len}"
        if window is None:
            assert cols == list(range(MB))            # every column exactly once


@pytest.mark.parametrize("B,K,G,MB,bt,window", [
    (16, 8, 5, 69, 16, None),       # the serving shape
    (1, 8, 5, 2048, 16, None),      # batch 1, 32 768 tokens
    (1, 8, 5, 2048, 16, 4096),      # the same with a window
])
def test_torch_split_plan_fills_the_card(B, K, G, MB, bt, window):
    n_gc, n_splits, cps = _split_plan(B, K, G, MB, bt, window, H100_SLOTS)
    assert 132 <= B * K * n_gc * n_splits <= H100_SLOTS


def _case(rng, B, H, K, hd, bt, MB, N, lens=None):
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    ks = rng.standard_normal((N, bt, K, hd)).astype(np.float32)
    vs = rng.standard_normal((N, bt, K, hd)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, MB * bt, B)
    lens = np.asarray(lens, np.int32)
    tables = np.full((B, MB), -1, np.int32)
    perm = rng.permutation(N)
    f = 0
    for b in range(B):
        nb = -(-int(lens[b]) // bt)
        tables[b, :nb] = perm[f:f + nb]
        f += nb
    return q, ks, vs, tables, lens


def _torch(arrays, dtype):
    q, ks, vs, tables, lens = arrays
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(ks).to(dtype),
            torch.from_numpy(vs).to(dtype), torch.from_numpy(tables),
            torch.from_numpy(lens))


@pytest.mark.parametrize("B,H,K,hd,bt,MB,N,window", [
    (2, 8, 2, 64, 16, 8, 32, None),
    (3, 4, 4, 128, 16, 4, 16, None),       # MHA
    (2, 16, 2, 64, 8, 16, 48, 24),         # sliding window
    (1, 4, 1, 32, 4, 4, 8, None),          # MQA, tiny blocks
])
@pytest.mark.parametrize("splits", ["plan", 1, 3, "past_live"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_split_combine_matches_plain_and_jax(B, H, K, hd, bt, MB, N, window,
                                                   splits, dtype):
    rng = np.random.default_rng(0)
    arrays = _case(rng, B, H, K, hd, bt, MB, N)
    tdtype = torch.float32 if dtype == "f32" else torch.bfloat16
    args = _torch(arrays, tdtype)
    if splits == "plan":
        _, n_splits, cps = _split_plan(B, K, H // K, MB, bt, window, H100_SLOTS)
    elif splits == "past_live":                # one column a split, and more
        n_splits, cps = MB + 3, 1              # splits than columns
    else:
        n_splits, cps = splits, -(-MB // splits)
    got = paged_attention_split_ref(*args, n_splits=n_splits, cols_per_split=cps,
                                    window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    want = paged_attention_ref(*args, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    kernel = jax_paged(*(jnp.asarray(a, jdtype) for a in arrays[:3]),
                       jnp.asarray(arrays[3]), jnp.asarray(arrays[4]), window=window)
    tol = 5e-5 if dtype == "f32" else 3e-2       # the reference's own bounds
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel, np.float32), atol=tol)


@pytest.mark.parametrize("window,lens,cps", [
    (None, [1, 17, 200, 1000], None),   # ragged, far below MB * bt: the plan's
                                        # late splits are empty
    (40, [1, 17, 200, 1000], 2),        # a window: columns before it in no split
    (16, [1000, 999, 33, 16], 1),       # a window of one block's width
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_split_combine_ragged_and_windowed(window, lens, cps, dtype):
    rng = np.random.default_rng(3)
    B, H, K, hd, bt, MB, N = 4, 8, 2, 32, 8, 160, 400
    arrays = _case(rng, B, H, K, hd, bt, MB, N, lens=lens)
    args = _torch(arrays, torch.float32 if dtype == "f32" else torch.bfloat16)
    if cps is None:
        _, n_splits, cps = _split_plan(B, K, H // K, MB, bt, window, H100_SLOTS)
    else:
        n_splits = -(-_window_span(MB, bt, window) // cps)
    assert n_splits > 1
    got = paged_attention_split_ref(*args, n_splits=n_splits, cols_per_split=cps,
                                    window=window)
    np.testing.assert_allclose(got.numpy(),
                               paged_attention_ref(*args, window=window).numpy(),
                               atol=5e-5)
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    kernel = jax_paged(*(jnp.asarray(a, jdtype) for a in arrays[:3]),
                       jnp.asarray(arrays[3]), jnp.asarray(arrays[4]), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel, np.float32),
                               atol=5e-5 if dtype == "f32" else 3e-2)


@pytest.mark.parametrize("n_splits,cps", [(1, 4), (3, 2), (7, 1)])
def test_torch_split_combine_dead_row_is_zero(n_splits, cps):
    """A padding row (all -1) gives only empty partials; they merge to 0,
    and a live row beside it is unchanged."""
    rng = np.random.default_rng(1)
    B, H, K, hd, bt, MB, N = 3, 4, 2, 16, 4, 4, 12
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    ks = torch.from_numpy(rng.standard_normal((N, bt, K, hd)).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((N, bt, K, hd)).astype(np.float32))
    tables = torch.tensor([[0, 1, -1, -1], [-1] * 4, [2, -1, -1, -1]],
                          dtype=torch.int32)
    lens = torch.tensor([6, 5, 3], dtype=torch.int32)
    out = paged_attention_split_ref(q, ks, vs, tables, lens, n_splits=n_splits,
                                    cols_per_split=cps)
    assert torch.equal(out[1], torch.zeros(H, hd))
    np.testing.assert_allclose(out.numpy(),
                               paged_attention_ref(q, ks, vs, tables, lens).numpy(),
                               atol=5e-5)


def _p_times_v(probs, v, split):
    """P V with P rounded as the tensor-core path sees it: one bf16 value,
    or a bf16 hi + lo pair (products and sums in f32)."""
    hi = probs.to(torch.bfloat16).float()
    p = hi + (probs - hi).to(torch.bfloat16).float() if split else hi
    return torch.einsum("bkgt,btkd->bkgd", p, v)


def test_torch_split_p_keeps_bf16_products_within_the_f32_bound():
    """At the serving shape (Qwen3-14B heads, 1 057 tokens) a P split into
    bf16 hi + lo stays inside the 5e-5 bound that the card's checks use; P
    rounded to one bf16 value does not, so the bound can see the split."""
    rng = np.random.default_rng(0)
    B, K, G, T, hd = 16, 8, 5, 1057, 128
    q = torch.from_numpy(rng.standard_normal((B, K, G, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, K, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, K, hd)).astype(np.float32))
    q, k, v = (x.to(torch.bfloat16).float() for x in (q, k, v))
    probs = torch.softmax(torch.einsum("bkgd,btkd->bkgt", q, k) * hd ** -0.5, -1)
    exact = torch.einsum("bkgt,btkd->bkgd", probs.double(), v.double())
    split_err = float((_p_times_v(probs, v, True).double() - exact).abs().max())
    naive_err = float((_p_times_v(probs, v, False).double() - exact).abs().max())
    assert split_err < 5e-6
    assert naive_err > 5e-5
