"""The least time of one paged latent-attention decode launch (K4, MLA),
kept apart from ``roofline.py``'s frozen copies: bytes count each input read
once and the output written once, operations the live (query head, slot)
pairs, and the bound is the larger of bytes over HBM bandwidth and
operations over the bf16 peak (``roofline``'s rates)."""
from __future__ import annotations

from .roofline import ELEMENT_BYTES, HBM_BPS, PEAK_FLOPS


def mla_bound(B: int, H: int, dv: int, dr: int, MB: int, n_live: int,
              dtype: str = "bfloat16") -> float:
    """Seconds: one K4 launch over B rows of H query heads, a cached latent
    of dv + dr columns a slot (V its first dv), tables of MB columns,
    ``n_live`` live slots in all.  Bytes: each live slot's latent once, q
    [B, H, dv + dr], the float32 output [B, H, dv], the tables and the
    lengths; operations: 2 H (dv + dr) for the scores and 2 H dv for P V a
    live slot."""
    e = ELEMENT_BYTES[dtype]
    dk = dv + dr
    nbytes = (n_live * dk * e + B * H * dk * e + B * H * dv * 4
              + B * MB * 4 + B * 4)
    flops = 2 * H * (dk + dv) * n_live
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype])
