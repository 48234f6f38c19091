"""Phase ``kernels_mla`` (also run by ``kernels``): K4 (``mla_decode``, the
paged decode of latent attention) against its plain version at Moonlight's
widths (a 512-wide latent and a 64-wide rope key, 16 heads, and 4 heads),
one split and many, a dead row, rows shorter than a stage; timed at
Moonlight's decode (B 64, 5 120 slots a row) and at the cell's shape (385
columns, rows of 4 112) beside gather + SDPA.
"""
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.launch.analysis import HBM_BW
from .common import check, DEV, make_tables, max_err, PEAK_FLOPS, randn, RNG, timed, TOL


def mla_case(B, H, dv, dr, bt, MB, N, lens=None, dead_row=False):
    """A K4 case: q [B,H,dv+dr], one latent slab [N,bt,1,dv+dr], tables and
    lengths as K1's cases make them; the softmax scale is 1/sqrt(192), the
    MLA one of Moonlight's 128 + 64 query width."""
    q = randn((B, H, dv + dr), torch.bfloat16)
    slab = randn((N, bt, 1, dv + dr), torch.bfloat16)
    tables, lens = make_tables(B, MB, bt, N, lens, dead_row)
    return (q, slab, tables, lens), {"scale": 192 ** -0.5, "dv": dv}


def mla_bound(args, kw):
    """Bytes: each live slot's latent once, q, the float32 output, the
    tables and lengths; operations: 2 H (dv + dr) + 2 H dv a live slot."""
    q, slab, tables, lens = args
    B, H, dk = q.shape
    bt, dv = slab.shape[1], kw["dv"]
    pos = torch.arange(tables.shape[1] * bt, device=DEV)[None, :]
    n_live = int(((pos < lens[:, None])
                  & (tables >= 0).repeat_interleave(bt, dim=1)).sum())
    nbytes = (n_live * dk * 2 + q.numel() * 2 + B * H * dv * 4
              + tables.numel() * 4 + lens.numel() * 4)
    return nbytes / HBM_BW, 2 * H * (dk + dv) * n_live / PEAK_FLOPS[q.dtype]


def mla_library(args, kw):
    """Yardstick only (the port never calls it): gather the latents, then
    SDPA with V the latents' first dv columns."""
    q, slab, tables, lens = args
    B, H, dk = q.shape
    bt = slab.shape[1]
    lat = slab.view(slab.shape[0], bt, dk)[tables.long().clamp_min(0)]
    lat = lat.reshape(B, 1, -1, dk)
    pos = torch.arange(lat.shape[2], device=DEV)[None, :]
    mask = (pos < lens[:, None]) & (tables >= 0).repeat_interleave(bt, dim=1)
    return F.scaled_dot_product_attention(
        q[:, :, None], lat.expand(B, H, -1, dk),
        lat[..., :kw["dv"]].expand(B, H, -1, kw["dv"]),
        attn_mask=mask[:, None, None, :], scale=kw["scale"])


def mla_p_bf16(q, slab, tables, lens, *, scale, dv):
    """The plain version with P rounded once to bf16 (the error a kernel
    without the hi + lo split of P would make)."""
    B, H, dk = q.shape
    bt = slab.shape[1]
    lat = slab.view(slab.shape[0], bt, dk)[tables.long().clamp_min(0)]
    lat = lat.reshape(B, -1, dk).float()
    pos = torch.arange(lat.shape[1], device=DEV)[None, :]
    live = (pos < lens[:, None]) & (tables >= 0).repeat_interleave(bt, dim=1)
    s = torch.einsum("bhd,btd->bht", q.float(), lat) * scale
    p = torch.softmax(s.masked_fill(~live[:, None], NEG_INF), -1) * live[:, None]
    p = p.to(torch.bfloat16).float()
    return torch.einsum("bht,btd->bhd", p, lat[..., :dv])


def phase_kernels_mla() -> dict:
    """K4's row (the module's docstring), with the combine's counters back
    at 0 and each timed shape's split count."""
    ref = paged_ops.mla_decode_ref
    fn = paged_ops.mla_decode
    cases = [mla_case(2, 16, 512, 64, 16, 8, 32),
             mla_case(3, 16, 512, 64, 16, 40, 128),
             mla_case(4, 16, 512, 64, 16, 8, 40, dead_row=True),
             mla_case(2, 4, 512, 64, 16, 8, 24),         # fewer heads than 16
             mla_case(5, 16, 512, 64, 16, 64, 400),
             mla_case(1, 16, 512, 64, 16, 1024, 1024),   # 16 384 slots, one row
             # ragged rows of 1-6 144 in the cell's table, some shorter than
             # a 64-slot stage
             mla_case(64, 16, 512, 64, 16, 385, 64 * 385,
                      lens=RNG.integers(1, 6145, 64)),
             # a row ending inside a stage, a dead row beside it
             mla_case(2, 16, 512, 64, 16, 70, 140, lens=[1000, 1000],
                      dead_row=True)]
    main = mla_case(64, 16, 512, 64, 16, 320, 64 * 320, lens=np.full(64, 5120))
    cell = mla_case(64, 16, 512, 64, 16, 385, 64 * 385, lens=np.full(64, 4112))
    err = 0.0
    for args, kw in cases + [main, cell]:
        got, want = fn(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        e = max_err(got, want)
        check(e <= TOL["paged_attention"],
              f"mla_decode {tuple(args[0].shape)}: |err| {e} > "
              f"{TOL['paged_attention']}")
        err = max(err, e)
    check(all(int(c.abs().sum()) == 0 for c, _ in paged_ops._SCRATCH.values()),
          "mla_decode left a combine counter nonzero")
    row = {"name": "mla_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "replaces": "none: no TPU kernel (the JAX package has no latent "
                       "attention); the port's plain mla_decode_ref",
           "launches": 0, **timed(fn, ref, mla_bound, mla_library, *main),
           "max_abs_err_by_dtype": {"bfloat16": err},
           "tolerance": TOL["paged_attention"], "cases": len(cases) + 2,
           "splits": paged_ops._mla_plan(0, 64, 320, 16, 512, 64),
           "cell": {**timed(fn, ref, mla_bound, mla_library, *cell),
                    "splits": paged_ops._mla_plan(0, 64, 385, 16, 512, 64)}}
    args, kw = main
    row["naive_p_bf16_err"] = max_err(mla_p_bf16(*args, **kw), ref(*args, **kw))
    check(row["naive_p_bf16_err"] > TOL["paged_attention"],
          f"rounding P to bf16 misses by {row['naive_p_bf16_err']}: the bound "
          "cannot see it")
    return row
