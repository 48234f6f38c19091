"""Phase ``kernels_bwd`` (also run by ``kernels``): K2's backward
(flash_attention_bwd) against its plain version (each of dq, dk, dv within
2e-5 of the plain gradient's largest magnitude) at the training shapes of
the attention archs (Yi-6B's q [8,32,1024,128], Gemma-3's head_dim 256 with
its 1 024 window, Whisper's non-causal encoder, RecurrentGemma's G = 10, a
ragged S, a head_dim of 80 below its tile's 128), bf16 up to head_dim 128
on the tensor cores (dO, P and dS as two bf16 halves) with a float32 dO and
with the train step's bf16-valued one (the kernels then skip the dO lo
products), float32 and bf16 at head_dim 256 on the FMA kernels; two runs
bit-equal; the forward's LSE against the plain one in both dtypes; a
dropped-tile control and a single-bf16 P / dS control that the bound must
see; and its time at Yi-6B's shape (both kinds of dO, and float32 inputs on
the FMA kernels) beside the plain version and SDPA's backward.
"""
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 ops as flash_ops)
from .common import (BWD_TOL_REL, check, flash_bwd_bound, flash_bwd_case, flash_bwd_rel,
                     FLASH_BWD_TRAIN, flash_visible, max_err, release, time_ms, TOL)


def flash_bwd_library(args, kw):
    """Yardstick only (the port never calls it): SDPA's backward alone, the
    forward run once beforehand; returns the call to time."""
    q, k, v, out, lse, dout = args
    leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=kw["causal"],
                                       enable_gqa=True)
    g = dout.to(o.dtype)
    return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)


def flash_bwd_plain(q, k, v, out, lse, dout, vis, p_bf16=False):
    """The plain backward over the visible pairs ``vis`` [S, S], with P and
    dS rounded to one bf16 value each before the products that take them
    when ``p_bf16``: the negative controls below."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G, scale = H // K, hd ** -0.5
    qg = q.reshape(B, K, G, S, hd).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    p = torch.where(vis, torch.exp(s - lse.reshape(B, K, G, S, 1)), 0.0)
    do = dout.reshape(B, K, G, S, hd)
    d = (do * out.reshape(B, K, G, S, hd)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bktd->bkgqt", do, v.float()) - d)
    if p_bf16:
        p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, do)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qg) * scale
    return dq.reshape(B, H, S, hd), dk, dv


def flash_bwd_drop_tile(q, k, v, out, lse, dout, *, causal, window):
    """Negative control, not part of the port: the plain backward with one
    64 x 64 tile of P (the last query rows against the first keys) dropped,
    as a kernel that skipped a live tile would compute.  It must miss the
    bound, or the bound could not see such a fault."""
    S = q.shape[2]
    vis = flash_visible(S, causal, window).clone()
    vis[S - 64:, :64] = False
    return flash_bwd_plain(q, k, v, out, lse, dout, vis)


def flash_bwd_p_bf16(q, k, v, out, lse, dout, *, causal, window):
    """Negative control, not part of the port: P and dS rounded to one bf16
    value each, as a tensor-core kernel without their lo halves would
    compute.  It must miss the bound, or the bound could not see the
    halves."""
    vis = flash_visible(q.shape[2], causal, window)
    return flash_bwd_plain(q, k, v, out, lse, dout, vis, p_bf16=True)


# one shard of Yi-6B's training shape at model = 2 (16 heads on 2 kv heads)
FLASH_BWD_SHARD = (8, 16, 2, 1024, 128, True, None)


def phase_kernels_bwd() -> dict:
    """K2's backward row (the module's docstring); the train step's
    bf16-valued dO takes the tensor-core kernels' zero-lo branch."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(row, dt, False) for dt in (f32, bf16) for row in [
        (2, 4, 2, 100, 16, True, None),          # ragged S, smoke head_dim
        (2, 4, 2, 100, 64, True, None), (1, 8, 2, 333, 128, True, 100),
        (1, 4, 2, 256, 64, False, None), (1, 2, 1, 70, 256, False, 33),
        (2, 8, 4, 1024, 128, True, None)]]
    cases += [
        (FLASH_BWD_TRAIN, bf16, False), ((2,) + FLASH_BWD_TRAIN[1:], f32, False),
        ((2, 8, 4, 2048, 256, True, 1024), bf16, False),  # Gemma-3's local layers
        ((4, 8, 8, 1500, 64, False, None), f32, False),   # Whisper's encoder
        ((2, 10, 1, 4096, 256, True, 2048), bf16, False), # RecurrentGemma's local
        ((2, 4, 2, 100, 80, True, None), bf16, False),    # head_dim below its tile's
        (FLASH_BWD_SHARD, bf16, False),                   # a model shard
    ]
    # the train step's bf16-valued dO: the zero-lo branch of the tensor cores
    cases += [(row, bf16, True) for row in [
        FLASH_BWD_TRAIN, (2, 4, 2, 100, 16, True, None),
        (1, 8, 2, 333, 128, True, 100), (1, 4, 2, 256, 64, False, None),
        (2, 6, 2, 77, 32, True, None), (2, 4, 2, 100, 80, True, None),
        FLASH_BWD_SHARD]]
    rel_by_dtype, lse_by_dtype = {}, {}
    for row, dt, dout_bf16 in cases:
        args, kw, lse_err = flash_bwd_case(*row, dt, dout_bf16=dout_bf16)
        rel = flash_bwd_rel(flash_attention_bwd(*args, **kw),
                            flash_attention_bwd_ref(*args, **kw))
        torch.cuda.synchronize()
        key = str(dt).replace("torch.", "") + ("/bf16_valued_dout" if dout_bf16 else "")
        check(max(rel.values()) <= BWD_TOL_REL,
              f"flash_attention_bwd {row} {key}: rel err {rel} > {BWD_TOL_REL}")
        check(lse_err <= TOL["flash_attention"],
              f"flash_attention lse {row} {dt}: |err| {lse_err}")
        rel_by_dtype[key] = max(rel_by_dtype.get(key, 0.0), *rel.values())
        lse_by_dtype[key] = max(lse_by_dtype.get(key, 0.0), lse_err)
        del args
    args, kw, lse_err = flash_bwd_case(*FLASH_BWD_TRAIN, bf16)
    got = flash_attention_bwd(*args, **kw)
    want = flash_attention_bwd_ref(*args, **kw)
    again = flash_attention_bwd(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "flash_attention_bwd: two runs on the same inputs differ")
    dropped = flash_bwd_rel(flash_bwd_drop_tile(*args, **kw), want)
    check(min(dropped.values()) > BWD_TOL_REL,
          f"a dropped tile misses by {dropped}, within {BWD_TOL_REL}: the "
          "bound cannot see it")
    single = flash_bwd_rel(flash_bwd_p_bf16(*args, **kw), want)
    check(min(single.values()) > BWD_TOL_REL,
          f"one bf16 P and dS miss by {single}, within {BWD_TOL_REL}: the "
          "bound cannot see the halves")
    # the train step's dO at the same shape, and the FMA route on float32
    # inputs there (the same kernels as the first design, wider inputs)
    args_b, kw_b, _ = flash_bwd_case(*FLASH_BWD_TRAIN, bf16, dout_bf16=True)
    args_f, kw_f, _ = flash_bwd_case(*FLASH_BWD_TRAIN, f32)
    t_bytes, t_ops = flash_bwd_bound(args, kw)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
           "tpu_backward": "none: the reference differentiates its plain jnp "
                           "attention (src/repro/models/attention.py:81)",
           "route_by_dtype": {"float32": flash_ops.bwd_route(f32, 128),
                              "bfloat16": flash_ops.bwd_route(bf16, 128),
                              "bfloat16_head_dim_256": flash_ops.bwd_route(bf16, 256)},
           "launches": 0,
           "max_abs_err": max_err(got, want),
           "rel_err": flash_bwd_rel(got, want),
           "ms": time_ms(lambda: flash_attention_bwd(*args, **kw)),
           "ms_bf16_valued_dout": time_ms(lambda: flash_attention_bwd(*args_b, **kw_b)),
           "ms_float32_fma": time_ms(lambda: flash_attention_bwd(*args_f, **kw_f)),
           "plain_ms": time_ms(lambda: flash_attention_bwd_ref(*args, **kw)),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": time_ms(flash_bwd_library(args, kw)),
           "library": "SDPA backward, is_causal, enable_gqa",
           "timed_shape": [list(a.shape) for a in args],
           "bit_reproducible": True,
           "max_rel_err_by_dtype": rel_by_dtype, "tolerance_rel": BWD_TOL_REL,
           "lse_max_abs_err_by_dtype": lse_by_dtype,
           "lse_tolerance": TOL["flash_attention"],
           "dropped_tile_rel_err": dropped, "p_bf16_rel_err": single,
           "cases": len(cases) + 1}
    del args, got, want, again, args_b, args_f
    # Yi-6B's shard at model = 2, the train step's bf16-valued dO
    args, kw, _ = flash_bwd_case(*FLASH_BWD_SHARD, bf16, dout_bf16=True)
    t_bytes, t_ops = flash_bwd_bound(args, kw)
    row["yi_6b_model_shard"] = {
        "rel_err": flash_bwd_rel(flash_attention_bwd(*args, **kw),
                                 flash_attention_bwd_ref(*args, **kw)),
        "ms": time_ms(lambda: flash_attention_bwd(*args, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_bwd_ref(*args, **kw)),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_ms(flash_bwd_library(args, kw)),
        "timed_shape": [list(a.shape) for a in args],
        "dout": "bf16-valued (the train step's)"}
    del args
    release()
    return row
