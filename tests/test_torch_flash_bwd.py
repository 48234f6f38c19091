"""The gradient of flash attention (K2) in the port, on the CPU.

``flash_attention_bwd_ref`` (the explicit formulas the CUDA backward
computes) is held against torch autograd of the port's plain forward and
against ``jax.vjp`` of the reference's ``flash_attention_ref``, on the same
numpy inputs: causal, windowed and non-causal masks, G in {1, 2, 5} query
heads a kv head, head_dim 64 and 128, and a ragged S.  float32 gradients
agree within 1e-5 of each gradient's largest magnitude (sums taken in
another order).  The autograd Function behind ``flash_attention`` is held
against both as the model calls it: through the transposed ``[B,S,H,hd]``
views ``attend`` hands over, and with bfloat16 inputs, whose gradients come
back in bfloat16.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention, flash_attention_bwd,
    flash_attention_bwd_ref, flash_attention_ref)

MASKS = {"causal": (True, None), "window": (True, 7), "full": (False, None)}


def _inputs(B, H, K, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, K, S, hd)).astype(np.float32)
    do = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    return q, k, v, do


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_grads(q, k, v, do, causal, window):
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_ref(a, b, c, causal=causal,
                                                   window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _autograd_grads(q, k, v, do, causal, window):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_ref(*t, causal=causal, window=window)
    return [g.numpy() for g in torch.autograd.grad(out, t, torch.from_numpy(do))]


@pytest.mark.parametrize("S", [40, 37])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 5])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_torch_flash_bwd_ref_matches_autograd_and_jax_vjp(mask, G, hd, S):
    causal, window = MASKS[mask]
    B, K = 2, 2
    q, k, v, do = _inputs(B, K * G, K, S, hd)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   return_lse=True)
    assert lse.shape == (B, K * G, S) and lse.dtype == torch.float32
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, torch.from_numpy(do),
                                  causal=causal, window=window)
    for name, g, a, j in zip(("dq", "dk", "dv"), got,
                             _autograd_grads(q, k, v, do, causal, window),
                             _jax_grads(q, k, v, do, causal, window)):
        assert g.dtype == torch.float32
        assert _rel(g, a) < 1e-5, (name, "autograd")
        assert _rel(g, j) < 1e-5, (name, "jax.vjp")


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_torch_flash_lse_is_the_rows_logsumexp(mask):
    """The LSE the forward hands to the backward: the natural log of the
    sum of exp(scale q.k) over each row's visible keys."""
    causal, window = MASKS[mask]
    q, k, v, _ = _inputs(2, 4, 2, 37, 64, seed=3)
    out, lse = flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal, window=window, return_lse=True)
    s = np.einsum("bkgqd,bktd->bkgqt", q.reshape(2, 2, 2, 37, 64), k) / 8.0
    i = np.arange(37)
    vis = np.ones((37, 37), bool)
    if causal:
        vis &= i[:, None] >= i[None, :]
    if window is not None:
        vis &= (i[:, None] - i[None, :]) < window
    want = np.asarray(jax.nn.logsumexp(jnp.where(vis, s, -jnp.inf), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want.reshape(2, 4, 37), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_flash_ref(q, k, v, causal=causal,
                                              window=window)), atol=1e-5)


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_torch_flash_attention_fn_through_transposed_views(mask, G):
    """The model's call: [B,S,heads,hd] projections handed over as
    [B,heads,S,hd] views; gradients reach the projections."""
    causal, window = MASKS[mask]
    B, K, S, hd = 2, 2, 29, 64
    q, k, v, do = _inputs(B, K * G, K, S, hd, seed=5)
    leaves = [torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
              .requires_grad_() for x in (q, k, v)]   # [B,S,heads,hd]
    before = flash_attention.launches
    out = flash_attention(*(t.transpose(1, 2) for t in leaves), causal=causal,
                          window=window)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith(
        FlashAttentionFn.__name__)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert flash_attention.launches == before       # no kernel on the CPU
    for name, g, a, j in zip(("dq", "dk", "dv"), grads,
                             _autograd_grads(q, k, v, do, causal, window),
                             _jax_grads(q, k, v, do, causal, window)):
        assert g.shape == leaves[0].shape[:2] + g.shape[2:]
        assert _rel(g.transpose(1, 2), a) < 1e-5, (name, "autograd")
        assert _rel(g.transpose(1, 2), j) < 1e-5, (name, "jax.vjp")


def test_torch_flash_attention_fn_bf16_grads_come_back_in_bf16():
    """bfloat16 inputs: the forward and backward work in float32 and each
    gradient is cast to its input's dtype; against the reference's vjp on
    the same bf16-rounded inputs within bf16 rounding of the result."""
    B, K, G, S, hd = 2, 2, 2, 33, 64
    q, k, v, do = _inputs(B, K * G, K, S, hd, seed=7)
    t = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*t, causal=True)
    assert out.dtype == torch.float32
    grads = torch.autograd.grad(out, t, torch.from_numpy(do))
    rounded = [x.detach().float().numpy() for x in t]
    for name, g, a, j in zip(("dq", "dk", "dv"), grads,
                             _autograd_grads(*rounded, do, True, None),
                             _jax_grads(*rounded, do, True, None)):
        assert g.dtype == torch.bfloat16, name
        assert _rel(g.float(), a) < 1e-2, name     # one bf16 rounding: 2^-8
        assert _rel(g.float(), j) < 1e-2, name


def test_torch_flash_attention_without_grad_keeps_no_lse():
    """Serving runs under no_grad: no autograd node, nothing saved, and the
    wrapper's CPU path is the plain forward."""
    q, k, v, _ = _inputs(1, 4, 2, 20, 16, seed=9)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = flash_attention(*t, causal=True)
    assert out.grad_fn is None
    plain = flash_attention(*(x.detach() for x in t), causal=True)
    assert plain.grad_fn is None and torch.equal(out, plain)


def test_torch_flash_attention_bwd_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, do = _inputs(1, 4, 2, 21, 32, seed=11)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_ref(tq, tk, tv, window=5, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(tq, tk, tv, out, lse, tdo, window=5)
    want = flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, window=5)
    assert flash_attention_bwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
