"""The operand rounding of K2's tensor-core backward, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` runs bfloat16 inputs (head_dim <= 128) on
``mma.sync`` tensor cores: bf16 operands, float32 accumulators.  Q, K and V
are exact in bf16; dO, P and dS are float32 and go in as two bf16 halves,
hi = bf16(x) and lo = bf16(x - hi):

    dP = dO_hi V^T + dO_lo V^T
    dV = P_hi dO_hi + P_hi dO_lo + P_lo dO_hi
    dK = scale (dS_hi Q + dS_lo Q),   dQ = scale (dS_hi K + dS_lo K)

``_emulate`` computes the same products in float32 torch and is held against
``flash_attention_bwd_ref`` within the card's bound (2e-5 of each gradient's
largest magnitude, ``chipcheck/common.py:BWD_TOL_REL``) at a causal GQA shape, a
windowed one and a ragged S, with a float32 dO and with the bf16-valued dO
of the train step (whose lo half is zero).  The negative control rounds P
and dS to one bf16 value each, as a kernel without the lo halves would: it
must miss the bound, or the bound could not tell the two designs apart.
The card's own float32 adds inside the tensor cores (which truncate) are not
emulated: the kernels sum each step's products from zero and add them to
the running sums with rounded adds, so the drift stays a step's worth.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.flash_attention.ops import bwd_route  # noqa: E402
from repro_torch.kernels.flash_attention.ref import visible_mask  # noqa: E402

BWD_TOL_REL = 2e-5
# name: ((B, H, K, S, hd, causal, window), seed)
SHAPES = {"causal_gqa": ((2, 8, 2, 192, 128, True, None), 10),
          "window": ((1, 4, 2, 160, 64, True, 48), 11),
          "ragged": ((2, 4, 2, 77, 64, True, None), 12)}


def _inputs(shape, seed, dout_kind):
    B, H, K, S, hd, causal, window = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in ((B, H, S, hd), (B, K, S, hd),
                                             (B, K, S, hd)))
    dout = torch.from_numpy(rng.standard_normal((B, H, S, hd)).astype(np.float32))
    if dout_kind == "bf16_valued":       # the train step's: lo half all zero
        dout = dout.to(torch.bfloat16).float()
    out, lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    return (q, k, v, out, lse, dout), {"causal": causal, "window": window}


def _halves(x, split):
    hi = x.to(torch.bfloat16).float()
    if not split:
        return hi, torch.zeros_like(x)
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate(q, k, v, out, lse, dout, *, causal, window, split=True):
    """The tensor-core backward's arithmetic: each product of bf16 operands
    summed in float32.  ``split=False`` keeps one bf16 P and dS (dO is
    still split)."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G, scale = H // K, hd ** -0.5
    qg = q.reshape(B, K, G, S, hd).float()
    kf, vf = k.float(), v.float()
    mask = visible_mask(S, causal, window)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, kf)
    p = torch.where(mask, torch.exp(s * scale - lse.reshape(B, K, G, S, 1)), 0.0)
    do = dout.reshape(B, K, G, S, hd)
    d = (do * out.reshape(B, K, G, S, hd)).sum(-1, keepdim=True)
    do_hi, do_lo = _halves(do, True)
    dp = (torch.einsum("bkgqd,bktd->bkgqt", do_hi, vf)
          + torch.einsum("bkgqd,bktd->bkgqt", do_lo, vf))
    ds = p * (dp - d)
    p_hi, p_lo = _halves(p, split)
    ds_hi, ds_lo = _halves(ds, split)
    dv = (torch.einsum("bkgqt,bkgqd->bktd", p_hi, do_hi)
          + torch.einsum("bkgqt,bkgqd->bktd", p_hi, do_lo)
          + torch.einsum("bkgqt,bkgqd->bktd", p_lo, do_hi))
    dk = (torch.einsum("bkgqt,bkgqd->bktd", ds_hi, qg)
          + torch.einsum("bkgqt,bkgqd->bktd", ds_lo, qg)) * scale
    dq = (torch.einsum("bkgqt,bktd->bkgqd", ds_hi, kf)
          + torch.einsum("bkgqt,bktd->bkgqd", ds_lo, kf)) * scale
    return dq.reshape(B, H, S, hd), dk, dv


def _rel(got, want) -> dict:
    return {name: float((g - w).abs().max() / w.abs().max())
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("dout_kind", ["float32", "bf16_valued"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_torch_flash_bwd_split_halves_hold_the_bound(shape, dout_kind):
    args, kw = _inputs(*SHAPES[shape], dout_kind)
    want = flash_attention_bwd_ref(*args, **kw)
    rel = _rel(_emulate(*args, **kw), want)
    assert max(rel.values()) <= BWD_TOL_REL, rel


@pytest.mark.parametrize("dout_kind", ["float32", "bf16_valued"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_torch_flash_bwd_single_bf16_p_and_ds_miss_the_bound(shape, dout_kind):
    args, kw = _inputs(*SHAPES[shape], dout_kind)
    want = flash_attention_bwd_ref(*args, **kw)
    rel = _rel(_emulate(*args, **kw, split=False), want)
    assert min(rel.values()) > BWD_TOL_REL, rel


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 16, "tensor_cores"), (torch.bfloat16, 80, "tensor_cores"),
    (torch.bfloat16, 112, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"), (torch.bfloat16, 256, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma")])
def test_torch_flash_bwd_route_by_dtype_and_head_dim(dtype, head_dim, route):
    """bf16 up to head_dim 128 runs the tensor-core kernels; above it (dK
    and dV would outgrow a thread's registers) and float32 the FMA ones."""
    assert bwd_route(dtype, head_dim) == route
