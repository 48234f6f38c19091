"""GQA attention: prefill self-attention (causal, windowed, or neither)
through the flash kernel, paged decode through the paged-attention kernel,
and, in plain PyTorch as the reference computes them outside any kernel, the
ring-buffer decode of the local-window layers and cross-attention (the
encoder-decoder's decoder: queries and keys of different lengths).

Decode reads KV through the paged block-table substrate — the physical frame
ids given to ``attn_decode_paged`` come from the block-table translation
(``PagedKVManager.physical_tables``), i.e. every decode step performs the
paper's address translation.

Over the grid's ``model`` axis (``tp``, a ``Pods``; tensor parallelism, the
reference's GSPMD layout made explicit) the projections are column-parallel
by whole heads: ``wq`` [p, D, Hs*hd] and ``wo`` [p, Hs*hd, D] hold each
local shard's Hs = H / t query heads, ``wk``/``wv`` [p, D, Ks*hd] its Ks =
K / t kv heads when t divides K, and stay replicated [D, K*hd] otherwise
(each shard then projects the one kv head its query heads share).  Every
shard runs the flash kernel (prefill) or the paged kernel (decode) on its own
heads, and ``wo``'s partial products are summed over the axis in
``cfg.dtype`` (``tp.psum``).  A replicated tensor read inside a shard's work
enters through ``tp.copy_in``.  A windowed layer's ring, and a decoder
layer's cross K/V, follow the paged slabs: split by kv head ``[p, B, ...,
Ks, hd]`` (one a local shard) or held once ``[B, ..., K, hd]``, each shard
reading and writing its kv heads of it; the ring decode and the
cross-attention then run per shard on its heads.

Multi-head latent attention (DeepSeek-V3's MLA, ``cfg.mla``: Moonlight)
caches one ``kv_lora_rank`` + ``qk_rope_head_dim`` wide latent a token,
shared by the heads: the normed latent c and the roped key k_pe.  Prefill
expands c through ``w_kv_b`` into each head's k_nope and v and runs K2 on q
and k of ``qk_nope_head_dim`` + ``qk_rope_head_dim`` with v zero-padded to
that width (K2's scale is then the published one); decode absorbs
``w_kv_b``'s key half into the query (q_lat = q_nope W_UK^T), runs the paged
MLA kernel over the latent slab (V is the latent's first ``kv_lora_rank``
columns), and un-absorbs the output through ``w_kv_b``'s value half.  MLA
runs unsplit: one data and one model shard.

The logit soft-cap (``cfg.attn_logit_softcap`` = c) caps every path's
scaled scores, ``c * tanh(s / c)``, before the mask, as the reference's
plain ``_gqa_scores`` does: K2 and K1 take it as an argument (a kernel
instance of its own), the plain ring decode and cross-attention apply it
themselves, and sequence-parallel decode passes it to each shard's K1.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import tracing
from ..distributed.pods import Pods
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import NEG_INF, soft_cap
from ..kernels.paged_attention.ops import mla_decode, paged_attention
from ..kvcache.gather import (decode_attention_sp, pooled_tables,
                              write_latent, write_token_plain)
from .common import (CacheLayout, ModelConfig, _dense, rms_norm, rope_tables,
                     rotate)


def init_attn(cfg: ModelConfig, gen: torch.Generator, dtype, cross: bool = False
              ) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": _dense(gen, (d, cfg.n_heads * hd), dtype),
        "wk": _dense(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": _dense(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": _dense(gen, (cfg.n_heads * hd, d), dtype),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
    return p


def init_mla(cfg: ModelConfig, gen: torch.Generator, dtype
             ) -> Dict[str, torch.Tensor]:
    """MLA's projections (module doc), DeepSeek-V3's layout: ``wq`` [D,
    H*(dn + dr)] (a head's nope then rope columns), ``w_kv_a`` [D, r + dr]
    (the latent, then the shared rope key), ``kv_norm`` [r] (the latent's
    RMSNorm scale), ``w_kv_b`` [r, H*(dn + dv)] (a head's k_nope then v
    columns), ``wo`` [H*dv, D]."""
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    return {"wq": _dense(gen, (d, H * (dn + dr)), dtype),
            "w_kv_a": _dense(gen, (d, r + dr), dtype),
            "kv_norm": torch.zeros((r,), dtype=dtype, device=gen.device),
            "w_kv_b": _dense(gen, (r, H * (dn + dv)), dtype),
            "wo": _dense(gen, (H * dv, d), dtype)}


def _project_qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 xq: torch.Tensor, xkv: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    hd = cfg.resolved_head_dim
    q = (xq @ p["wq"].to(cfg.dtype)).reshape(B, Sq, cfg.n_heads, hd)
    k = (xkv @ p["wk"].to(cfg.dtype)).reshape(B, Skv, cfg.n_kv_heads, hd)
    v = (xkv @ p["wv"].to(cfg.dtype)).reshape(B, Skv, cfg.n_kv_heads, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


Rope = Tuple[torch.Tensor, torch.Tensor]      # (cos, sin) of rope_tables


def rope_for(cfg: ModelConfig, positions: torch.Tensor, theta: float
             ) -> Optional[Rope]:
    """The RoPE tables of ``positions`` [..., seq], or None for a config
    without RoPE (learned or sinusoidal positions)."""
    if not cfg.use_rope:
        return None
    return rope_tables(positions, cfg.qk_rope_head_dim if cfg.mla
                       else cfg.resolved_head_dim, theta)


def project_qk_rope_v(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, rope: Optional[Rope]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention projections, RoPE on q and k unless ``rope`` is None:
    each [B,S,heads,hd]."""
    q, k, v = _project_qkv(cfg, p, x, x)
    if rope is None:
        return q, k, v
    return rotate(q, rope), rotate(k, rope), v


def attend(cfg: ModelConfig, p: Dict[str, torch.Tensor],
           q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           store: Optional[Callable] = None) -> torch.Tensor:
    """The flash kernel on projected q/k/v [B,S,heads,hd] (one S), then
    ``wo``.  The kernel takes [B,heads,S,hd]: it is handed transposed views
    (it reads through strides, no copy is made).  ``store(k, v)``, when
    given, writes the prompt's K/V into the cache after the kernel (the
    prefill's scatter); the two are the span ``attn.kernel``."""
    B, S = q.shape[:2]
    with tracing.span("attn.kernel"):
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap)
        if store is not None:
            store(k, v)
    out = out.to(cfg.dtype).transpose(1, 2).reshape(B, S, -1)
    return out @ p["wo"].to(cfg.dtype)


def cross_kv(cfg: ModelConfig, p: Dict[str, torch.Tensor], kv_x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values [B,Se,K,hd] of the encoder output
    ``kv_x``, in its dtype (the weights are rounded to ``cfg.dtype`` first,
    as the reference's promotion of a float32 encoder output computes)."""
    B, Se, _ = kv_x.shape
    hd = cfg.resolved_head_dim
    k = kv_x @ p["wk"].to(cfg.dtype).to(kv_x.dtype)
    v = kv_x @ p["wv"].to(cfg.dtype).to(kv_x.dtype)
    return (k.reshape(B, Se, cfg.n_kv_heads, hd),
            v.reshape(B, Se, cfg.n_kv_heads, hd))


def _cross(cfg: ModelConfig, q: torch.Tensor, ck: torch.Tensor,
           cv: torch.Tensor) -> torch.Tensor:
    """Unmasked attention of q [B,Sq,H,hd] on ck/cv [B,Se,K,hd] (H a
    multiple of K), float32 -> [B,Sq,H*hd] in ``cfg.dtype``."""
    B, Sq, H, hd = q.shape
    K = ck.shape[2]
    q = q.reshape(B, Sq, K, H // K, hd)
    scores = soft_cap(torch.einsum("bqkgd,bskd->bkgqs", q.float(), ck.float())
                      * hd ** -0.5, cfg.attn_logit_softcap)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cv.float())
    return out.reshape(B, Sq, H * hd).to(cfg.dtype)


def cross_attention(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor
                    ) -> torch.Tensor:
    """Cross-attention of decoder rows x [B,Sq,D] on encoder keys and values
    ck/cv [B,Se,K,hd], unmasked.  Scores, softmax and P·V are float32 (the
    reference rounds P to bf16 in a bf16 run; the port keeps it, as its
    kernels do), then ``wo`` in ``cfg.dtype``.  Plain PyTorch on both
    devices: the flash kernel takes one length for queries and keys."""
    B, Sq, _ = x.shape
    q = (x @ p["wq"].to(cfg.dtype)).reshape(B, Sq, cfg.n_heads, -1)
    return _cross(cfg, q, ck, cv) @ p["wo"].to(cfg.dtype)


def attn_decode_paged(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, positions: torch.Tensor,
                      kv: Tuple[torch.Tensor, torch.Tensor],
                      phys_blocks: torch.Tensor, seq_lens: torch.Tensor, *,
                      rope: Rope, window: Optional[int] = None,
                      sp: bool = False, pods: Optional[Pods] = None,
                      pools: int = 1
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decode step (one new token per sequence) with paged KV.

    x: [B, 1, D]; positions: [B]; kv: (k_slabs, v_slabs) for THIS layer,
    each [n_blocks, bt, K, hd], or with ``pools`` = P > 1 pool-partitioned
    [P, F_local, bt, K, hd], and UPDATED IN PLACE; phys_blocks: [B,
    max_blocks] physical frame ids from the block-table translation (-1 =
    absent; local to the row's pool when pooled); seq_lens: [B] length
    INCLUDING the new token; rope: the
    step's (cos, sin) tables of ``rope_for(cfg, positions[:, None], ...)``
    (None without RoPE), made once by the caller because every layer of a
    group shares them.  ``sp``: sequence-parallel decode over the pools
    (``kvcache.gather.decode_attention_sp``; over ``pods`` when given, the
    pools then being this process's).
    Returns (attn_out [B,1,D], the same slabs).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    bt = kv[0].shape[-3]
    q, k_new, v_new = project_qk_rope_v(cfg, p, x, rope)
    if sp:
        out, k_slabs, v_slabs = decode_attention_sp(
            q[:, 0].contiguous(), kv[0], kv[1], k_new[:, 0], v_new[:, 0],
            phys_blocks, positions, seq_lens, block_tokens=bt,
            n_kv=cfg.n_kv_heads, window=window, pods=pods,
            softcap=cfg.attn_logit_softcap)
    else:
        k_slabs, v_slabs, tables = kv[0], kv[1], phys_blocks
        if pools > 1:
            # pools flattened, rows' frames made global: one launch
            tables = pooled_tables(phys_blocks, *k_slabs.shape[:2])
            k_slabs = k_slabs.flatten(0, 1)
            v_slabs = v_slabs.flatten(0, 1)
        # write the new token's KV, then attend through the block table
        with tracing.span("attn.kernel"):
            write_token_plain(k_slabs, v_slabs, k_new[:, 0], v_new[:, 0],
                              tables, positions, bt)
            out = paged_attention(q[:, 0].contiguous(), k_slabs, v_slabs,
                                  tables, seq_lens, window=window,
                                  softcap=cfg.attn_logit_softcap)
        k_slabs, v_slabs = kv
    out = out.reshape(B, 1, cfg.n_heads * hd).to(cfg.dtype)
    out = out @ p["wo"].to(cfg.dtype)
    return out, (k_slabs, v_slabs)


# ------------------------------------------------------ latent attention
def mla_latent(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               rope: Rope) -> torch.Tensor:
    """x [B,S,D] -> the latents [B,S,r + dr] a token caches: c through its
    RMSNorm, then k_pe roped, in ``cfg.dtype``."""
    r = cfg.kv_lora_rank
    kv = x @ p["w_kv_a"].to(cfg.dtype)
    c = rms_norm(kv[..., :r], p["kv_norm"])
    k_pe = rotate(kv[..., None, r:], rope)[..., 0, :]
    return torch.cat([c, k_pe], dim=-1)


def mla_queries(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                rope: Rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (q_nope [B,S,H,dn], a view; q_pe [B,S,H,dr] roped)."""
    B, S, _ = x.shape
    dn = cfg.qk_nope_head_dim
    q = (x @ p["wq"].to(cfg.dtype)).view(B, S, cfg.n_heads, -1)
    return q[..., :dn], rotate(q[..., dn:], rope)


def mla_attend(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               rope: Rope, *, causal: bool = True,
               store: Optional[Callable] = None) -> torch.Tensor:
    """MLA over a whole sequence x [B,S,D] -> [B,S,D] (module doc): K2 on
    [q_nope, q_pe] and [k_nope, k_pe] at dn + dr, v zero-padded to that
    width, the output cut to dv.  ``store(latent)``, when given, writes the
    prompt's latents [B,S,r + dr] into the cache: it and the latent's
    projection are the span ``attn.latent``; K2 is ``attn.kernel``."""
    B, S, _ = x.shape
    H, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_head_dim,
                        cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    if dv > dn + dr:
        raise ValueError(f"{cfg.name}: v_head_dim {dv} wider than q and k")
    with tracing.span("attn.latent"):
        latent = mla_latent(cfg, p, x, rope)
        if store is not None:
            store(latent)
    q_nope, q_pe = mla_queries(cfg, p, x, rope)
    kv = (latent[..., :r] @ p["w_kv_b"].to(cfg.dtype)).view(B, S, H, dn + dv)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([kv[..., :dn],
                   latent[..., None, r:].expand(B, S, H, dr)], dim=-1)
    v = torch.nn.functional.pad(kv[..., dn:], (0, dn + dr - dv))
    with tracing.span("attn.kernel"):
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    out = out[..., :dv].to(cfg.dtype).transpose(1, 2).reshape(B, S, H * dv)
    return out @ p["wo"].to(cfg.dtype)


def attn_decode_mla(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, positions: torch.Tensor,
                    slab: torch.Tensor, phys_blocks: torch.Tensor,
                    seq_lens: torch.Tensor, *, rope: Rope, pools: int = 1
                    ) -> torch.Tensor:
    """One MLA decode step (module doc) of x [B,1,D] over this layer's
    latent slab ``[N, bt, 1, r + dr]`` (pooled ``[P, N/P, bt, 1, r + dr]``,
    read through ``pooled_tables``), UPDATED IN PLACE with each row's new
    latent; ``positions``, ``phys_blocks``, ``seq_lens`` and ``rope`` as
    for ``attn_decode_paged``.  Spans: ``attn.latent`` (the latent and its
    write), ``attn.kernel`` (the absorb product, the paged MLA kernel, the
    un-absorb product).  Returns the attention output [B,1,D]."""
    B = x.shape[0]
    H, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_head_dim,
                        cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    bt = slab.shape[-3]
    tables = phys_blocks
    if pools > 1:
        tables = pooled_tables(phys_blocks, *slab.shape[:2])
        slab = slab.flatten(0, 1)
    with tracing.span("attn.latent"):
        write_latent(slab, mla_latent(cfg, p, x, rope)[:, 0], tables,
                     positions, bt)
    q_nope, q_pe = mla_queries(cfg, p, x, rope)
    w = p["w_kv_b"].to(cfg.dtype).view(r, H, dn + dv)
    with tracing.span("attn.kernel"):
        # [H,B,dn] @ [H,dn,r]: each head's query in the latent's space
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1),
                          w[..., :dn].permute(1, 2, 0))
        q = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
        out = mla_decode(q, slab, tables, seq_lens, scale=(dn + dr) ** -0.5,
                         dv=r)
        # [H,B,r] @ [H,r,dv]: the latent's output through each head's v
        out = torch.bmm(out.to(cfg.dtype).transpose(0, 1),
                        w[..., dn:].transpose(0, 1))
    out = out.transpose(0, 1).reshape(B, 1, H * dv)
    return out @ p["wo"].to(cfg.dtype)


# ----------------------------------------------------------------- model axis
def heads_sharded(p: Dict[str, torch.Tensor]) -> bool:
    """Whether this attention's heads are split over the model axis (its
    ``wq`` carries a leading local-shard dimension)."""
    return p["wq"].dim() == 3


class ShardHeads:
    """The heads of one model shard: its query heads [q0, q0 + Hs) and the
    kv heads [kv0, kv0 + Ks) they read."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 shard: int):
        hd = cfg.resolved_head_dim
        self.Hs = p["wq"].shape[-1] // hd
        self.q0 = shard * self.Hs
        if p["wk"].dim() == 3:                  # whole kv heads a shard
            self.Ks = p["wk"].shape[-1] // hd
            self.kv0 = shard * self.Ks
        else:                                   # one replicated kv head
            self.kv0, self.Ks = self.q0 // cfg.q_per_kv, 1


def _project_shard(cfg: ModelConfig, p: Dict[str, torch.Tensor], i: int,
                   heads: ShardHeads, x: torch.Tensor,
                   shared: Dict[str, torch.Tensor], rope: Optional[Rope]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,S,Hs,hd], k and v [B,S,Ks,hd] of local shard ``i`` from its
    copy x of the input (``copy_in``'s [i]); ``shared``: the replicated
    tensors the shards read (``wk``/``wv`` when replicated, the qk-norm
    scales), through ``copy_in`` ([p, ...])."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"][i].to(cfg.dtype)).reshape(B, S, heads.Hs, hd)
    if "wk" in shared:
        cols = slice(heads.kv0 * hd, (heads.kv0 + heads.Ks) * hd)
        wk, wv = shared["wk"][i][:, cols], shared["wv"][i][:, cols]
    else:
        wk, wv = p["wk"][i], p["wv"][i]
    k = (x @ wk.to(cfg.dtype)).reshape(B, S, heads.Ks, hd)
    v = (x @ wv.to(cfg.dtype)).reshape(B, S, heads.Ks, hd)
    if cfg.qk_norm and "q_norm" in shared:
        q = rms_norm(q, shared["q_norm"][i])
        k = rms_norm(k, shared["k_norm"][i])
    if rope is not None:
        q, k = rotate(q, rope), rotate(k, rope)
    return q, k, v


def _kv_of(kv: torch.Tensor, i: int, heads: ShardHeads, split: bool
           ) -> torch.Tensor:
    """A local shard's part of a layer's ring or cross K/V: its own when
    ``split`` ``[p, B, ..., Ks, hd]``, its kv heads of the one held
    replicated ``[B, ..., K, hd]`` (a view)."""
    if split:
        return kv[i]
    return kv[..., heads.kv0:heads.kv0 + heads.Ks, :]


def _shared(p: Dict[str, torch.Tensor], tp: Pods) -> Dict[str, torch.Tensor]:
    names = [n for n in ("q_norm", "k_norm") if n in p]
    if p["wk"].dim() == 2:
        names += ["wk", "wv"]
    return {n: tp.copy_in(p[n]) for n in names}


def attend_tp(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              rope: Optional[Rope], tp: Pods, *, causal: bool = True,
              window: Optional[int] = None,
              store: Optional[Callable] = None) -> torch.Tensor:
    """Self-attention of a whole sequence x [B,S,D] over the model axis:
    each local shard projects its heads, runs the flash kernel on them (one
    launch a shard, on strided [B,Hs,S,hd] views), hands its k, v [B,S,Ks,hd]
    to ``store(i, heads, k, v)`` when given (the prefill's cache writes),
    and multiplies by its rows of ``wo``; the partials are summed over the
    axis in ``cfg.dtype`` (``tp.block_in`` / ``block_out``).  Returns the
    replicated output [B,S,D], or each shard's rows of it under sequence
    parallelism."""
    B, S, _ = x.shape
    xin, shared = tp.block_in(x), _shared(p, tp)
    parts: List[torch.Tensor] = []
    for i, shard in enumerate(tp.local_indices()):
        heads = ShardHeads(cfg, p, shard)
        q, k, v = _project_shard(cfg, p, i, heads, xin[i], shared, rope)
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap)
        if store is not None:
            store(i, heads, k, v)
        out = out.to(cfg.dtype).transpose(1, 2).reshape(B, S, -1)
        parts.append(out @ p["wo"][i].to(cfg.dtype))
    return tp.block_out(torch.stack(parts))


def attn_decode_paged_tp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                         x: torch.Tensor, positions: torch.Tensor,
                         kv: Tuple[torch.Tensor, torch.Tensor],
                         phys_blocks: torch.Tensor, seq_lens: torch.Tensor, *,
                         rope: Optional[Rope], tp: Pods, layout: CacheLayout,
                         window: Optional[int] = None, sp: bool = False,
                         pods: Optional[Pods] = None) -> torch.Tensor:
    """One decode step over the model axis.  kv: this layer's slabs, as
    ``layout`` holds them: replicated [(P,) N, bt, K, hd] (held once; each
    shard writes and reads its own kv heads of it, K1 taking the head range
    of the contiguous slab) or split [p, (P,) N, bt, Ks, hd] (one contiguous
    K1 operand a local shard).  Pooled slabs are read through the rows'
    global frames (``pooled_tables``), one K1 launch a shard over the
    flattened pools; with ``sp`` each shard instead decodes its heads
    sequence-parallel over the pools (``decode_attention_sp``: its kv heads
    of each pool written, one K1 launch with ``kv_heads`` and ``lse`` a
    pool, the pools' partials of its heads combined).  Returns the
    replicated attention output [B,1,D]: the shards' row-parallel ``wo``
    products summed over the axis."""
    B = x.shape[0]
    bt = kv[0].shape[-3]
    tables = phys_blocks
    if layout.pools > 1 and not sp:
        tables = pooled_tables(phys_blocks, layout.pools, kv[0].shape[-4])
    xin, shared = tp.copy_in(x), _shared(p, tp)
    parts: List[torch.Tensor] = []
    for i, shard in enumerate(tp.local_indices()):
        heads = ShardHeads(cfg, p, shard)
        q, k_new, v_new = _project_shard(cfg, p, i, heads, xin[i], shared,
                                         rope)
        # this shard's own slabs, or its kv heads of the shared ones
        kv_heads = None if layout.split else (heads.kv0, heads.Ks)
        mine = (slice(None) if layout.split
                else slice(heads.kv0, heads.kv0 + heads.Ks))
        q = q[:, 0].contiguous()
        if sp:
            ks, vs = (kv[0][i], kv[1][i]) if layout.split else kv
            out = decode_attention_sp(
                q, ks, vs, k_new[:, 0], v_new[:, 0], phys_blocks, positions,
                seq_lens, block_tokens=bt, n_kv=heads.Ks, window=window,
                pods=pods, softcap=cfg.attn_logit_softcap,
                kv_heads=kv_heads)[0]
        else:
            ks, vs = layout.shard_slab(kv[0], i), layout.shard_slab(kv[1], i)
            write_token_plain(ks[..., mine, :], vs[..., mine, :], k_new[:, 0],
                              v_new[:, 0], tables, positions, bt)
            out = paged_attention(q, ks, vs, tables, seq_lens, window=window,
                                  kv_heads=kv_heads,
                                  softcap=cfg.attn_logit_softcap)
        out = out.reshape(B, 1, -1).to(cfg.dtype)
        parts.append(out @ p["wo"][i].to(cfg.dtype))
    return tp.psum(torch.stack(parts))[0]


def cross_kv_tp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                kv_x: torch.Tensor, tp: Pods
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cross_kv`` of each local shard's kv heads: k, v [p, B, Se, Ks, hd]
    (a replicated kv projection read through ``tp.copy_in``)."""
    B, Se, _ = kv_x.shape
    hd = cfg.resolved_head_dim
    xin, shared = tp.copy_in(kv_x), _shared(p, tp)
    ks, vs = [], []
    for i, shard in enumerate(tp.local_indices()):
        heads = ShardHeads(cfg, p, shard)
        if "wk" in shared:
            cols = slice(heads.kv0 * hd, (heads.kv0 + heads.Ks) * hd)
            wk, wv = shared["wk"][i][:, cols], shared["wv"][i][:, cols]
        else:
            wk, wv = p["wk"][i], p["wv"][i]
        ks.append((xin[i] @ wk.to(cfg.dtype).to(kv_x.dtype))
                  .reshape(B, Se, heads.Ks, hd))
        vs.append((xin[i] @ wv.to(cfg.dtype).to(kv_x.dtype))
                  .reshape(B, Se, heads.Ks, hd))
    return torch.stack(ks), torch.stack(vs)


def cross_attention_tp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                       x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                       tp: Pods, *, split: bool) -> torch.Tensor:
    """``cross_attention`` over the model axis: each local shard's query
    heads on its kv heads of ck / cv (``_kv_of``: ``split`` [p, B, Se, Ks,
    hd] or replicated [B, Se, K, hd]), then its rows of ``wo``, summed over
    the axis."""
    B, Sq, _ = x.shape
    xin = tp.block_in(x)
    parts = []
    for i, shard in enumerate(tp.local_indices()):
        heads = ShardHeads(cfg, p, shard)
        q = (xin[i] @ p["wq"][i].to(cfg.dtype)).reshape(B, Sq, heads.Hs, -1)
        out = _cross(cfg, q, _kv_of(ck, i, heads, split),
                     _kv_of(cv, i, heads, split))
        parts.append(out @ p["wo"][i].to(cfg.dtype))
    return tp.block_out(torch.stack(parts))


def _ring_step(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
               ring_k: torch.Tensor, ring_v: torch.Tensor,
               positions: torch.Tensor, window: int,
               softcap: Optional[float] = None) -> torch.Tensor:
    """The ring decode of one step: q [B,H,hd] on rings [B,window,K,hd]
    (written in place: the new k, v [B,K,hd] go to slot positions %
    window) -> [B, H*hd] float32.  ``softcap``: the logit cap."""
    B, H, hd = q.shape
    K = ring_k.shape[2]
    pos = positions.long()
    rows = torch.arange(B, device=q.device)
    ring_k[rows, pos % window] = k_new.to(ring_k.dtype)
    ring_v[rows, pos % window] = v_new.to(ring_v.dtype)
    scores = soft_cap(torch.einsum("bkgd,bskd->bkgs",
                                   q.reshape(B, K, H // K, hd).float(),
                                   ring_k.float()) * hd ** -0.5, softcap)
    idx = torch.arange(window, device=q.device)[None, :]
    pos = pos[:, None]
    pos_in_slot = pos - (pos - idx) % window
    valid = ((pos_in_slot >= 0) & (pos_in_slot >= pos - window + 1)
             & (pos_in_slot <= pos))
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, ring_v.float())
    return out.reshape(B, H * hd)


def attn_decode_ring(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, positions: torch.Tensor,
                     ring_k: torch.Tensor, ring_v: torch.Tensor, *,
                     rope: Optional[Rope], window: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of a sliding-window layer whose KV is a ring of
    ``window`` slots per sequence: slot i holds the latest position p with
    p % window == i.

    x: [B, 1, D]; positions: [B]; ring_k/ring_v: [B, window, K, hd] for THIS
    layer, UPDATED IN PLACE (the new token goes to slot positions % window);
    rope: the step's tables, as for ``attn_decode_paged``.  Scores, softmax
    and the product with V are float32.  Returns (attn_out [B,1,D], ring_k,
    ring_v)."""
    B = x.shape[0]
    q, k_new, v_new = project_qk_rope_v(cfg, p, x, rope)
    out = _ring_step(q[:, 0], k_new[:, 0], v_new[:, 0], ring_k, ring_v,
                     positions, window, cfg.attn_logit_softcap)
    out = out.reshape(B, 1, -1).to(cfg.dtype)
    return out @ p["wo"].to(cfg.dtype), ring_k, ring_v


def attn_decode_ring_tp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                        x: torch.Tensor, positions: torch.Tensor,
                        rings: Tuple[torch.Tensor, torch.Tensor], *,
                        rope: Optional[Rope], tp: Pods, window: int,
                        split: bool) -> torch.Tensor:
    """``attn_decode_ring`` over the model axis: each local shard projects
    its heads and decodes them from its kv heads of this layer's rings
    (``split`` [p, B, W, Ks, hd] or replicated [B, W, K, hd], ``_kv_of``; written
    in place), then its rows of ``wo``, summed over the axis.  Returns the
    replicated attention output [B,1,D]."""
    B = x.shape[0]
    xin, shared = tp.copy_in(x), _shared(p, tp)
    parts: List[torch.Tensor] = []
    for i, shard in enumerate(tp.local_indices()):
        heads = ShardHeads(cfg, p, shard)
        q, k_new, v_new = _project_shard(cfg, p, i, heads, xin[i], shared,
                                         rope)
        out = _ring_step(q[:, 0], k_new[:, 0], v_new[:, 0],
                         _kv_of(rings[0], i, heads, split),
                         _kv_of(rings[1], i, heads, split),
                         positions, window, cfg.attn_logit_softcap)
        parts.append(out.reshape(B, 1, -1).to(cfg.dtype)
                     @ p["wo"][i].to(cfg.dtype))
    return tp.psum(torch.stack(parts))[0]
