"""Phase ``kernels``: each hand-written kernel against its plain PyTorch
version on the card, at the reference's test shapes and at the full-width
shapes of the serving paths (Qwen3-14B at head_dim 128, Gemma-3-4B at
head_dim 256, K2 with and without Gemma's window, Qwen3-235B-A22B at 16
query heads a kv head, Kimi-K2 at head_dim 112, Yi-6B, Whisper's non-causal
encoder over 1 500 frames and its decoder at G = 1, head_dim 64,
RecurrentGemma's 10 query heads on one kv head with its 2 048 window); timed
against the plain version, a PyTorch library call and the card's bound.
K1's per-row log-sum-exp (``lse``) against the plain version's (within
1e-5, both dtypes, a dead row, shard-local lengths past either end of a
shard, with and without a window, one split and many), timed at the
sequence-parallel shard shape; and with ``kv_heads`` as well (a model
shard's SP launch at model 2: q [1,20,128] on kv heads 4-7 of a pool,
timed), and K1 on a shard's kv heads of 4 pools flattened through
pool-global tables (Qwen3-14B at model 2 over 4 pools, timed).  The page
walk's checks are ``walk``'s; K2's backward, the soft-cap rows and K4 run
as their own phases do (``kernels_bwd``, ``kernels_cap``, ``kernels_mla``).
"""
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.kernels.paged_attention import (ops as paged_ops, paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.pte_gather import pte_gather_ref
from repro_torch.kvcache import gather as kv_gather
from .common import (check, DEV, flash_bound, flash_case, flash_visible, KERNEL_FNS,
                     lse_cases, LSE_TOL, max_err, paged_bound, paged_case,
                     paged_library, paged_lse, paged_lse_bound, POOLS, RNG, SP_SHARD,
                     timed, TOL)
from .kernels_bwd import phase_kernels_bwd
from .kernels_cap import phase_kernels_cap
from .kernels_mla import phase_kernels_mla
from .walk import (coherence_roles, pte_bound, pte_case, pte_checked, pte_library,
                   pte_mutations_random, pte_rejections, serving_walk_cases, walk_args,
                   walk_one_launch, walk_staging_growth)


def paged_p_bf16(q, ks, vs, tables, lens, *, window):
    """Negative control, not part of the port: the plain version with the
    softmax probabilities rounded to bf16 before P V, as a kernel that keeps
    P in one bf16 operand would compute.  The kernel splits P into two bf16
    halves instead; this shows that its tolerance can see the difference."""
    B, H, hd = q.shape
    _, bt, K, _ = ks.shape
    frames = tables.long().clamp_min(0)
    k = ks[frames].reshape(B, -1, K, hd).float()
    v = vs[frames].reshape(B, -1, K, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, K, -1, hd).float(), k) * hd ** -0.5
    pos = torch.arange(k.shape[1], device=DEV)[None, :]
    live = (pos < lens[:, None]) & (tables >= 0).repeat_interleave(bt, dim=1)
    if window is not None:
        live &= pos >= lens[:, None] - window
    s = s.masked_fill(~live[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float() * live[:, None, None, :]
    return torch.einsum("bkgt,btkd->bkgd", p, v).reshape(B, H, hd)


def flash_library(args, kw):
    """Yardstick only (the port never calls it): one SDPA call."""
    q, k, v = args
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    if kw["window"] is None:
        return F.scaled_dot_product_attention(q, k, v, is_causal=kw["causal"])
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=flash_visible(q.shape[2], **kw))


def flash_p_bf16(q, k, v, *, causal, window):
    """Negative control, not part of the port: the plain version with the
    softmax probabilities rounded to bf16 before P V, as a kernel that keeps
    P in one bf16 operand would compute.  The kernel splits P into two bf16
    halves instead; this shows that its tolerance can see the difference."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    s = torch.einsum("bkgqd,bktd->bkgqt", q.reshape(B, -1, G, S, hd).float(),
                     k.float()) * hd ** -0.5
    s = s.masked_fill(~flash_visible(S, causal, window), NEG_INF)
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bkgqt,bktd->bkgqd", p, v.float()).reshape(B, H, S, hd)


def phase_kernels_lse() -> dict:
    """K1's LSE output against the plain version's: the output within K1's
    bound, the LSE within LSE_TOL (rows with no live slot: NEG_INF in both);
    then timed at the shard shape."""
    kern, ref = paged_lse(paged_attention), paged_lse(paged_attention_ref)
    errs = {"out": 0.0, "lse": 0.0}
    splits = set()
    for args, kw in lse_cases():
        (out, lse), (want, want_lse) = kern(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, want), max_err(lse, want_lse)
        check(e_out <= TOL["paged_attention"] and e_lse <= LSE_TOL,
              f"K1 with lse {tuple(args[0].shape)} lens {args[4].tolist()[:4]} "
              f"{args[0].dtype}: out {e_out}, lse {e_lse}")
        check(bool(((want_lse == NEG_INF) == (lse == NEG_INF)).all()),
              "K1's lse marks other rows dead than the plain version")
        errs = {"out": max(errs["out"], e_out), "lse": max(errs["lse"], e_lse)}
        B, H, hd = args[0].shape
        splits.add(paged_ops._plan(DEV.index, paged_ops._DTYPES[args[0].dtype],
                                   B, H, args[1].shape[2], hd, args[3].shape[1],
                                   args[1].shape[1], kw["window"])[1])
    check(1 in splits and max(splits) > 1, f"lse cases ran splits {splits}")
    args, kw = paged_case(*SP_SHARD, None, torch.bfloat16, lens=[8192])
    return {"cases": len(lse_cases()), "max_abs_err_out": errs["out"],
            "max_abs_err_lse": errs["lse"], "tolerance_lse": LSE_TOL,
            "splits_run": sorted(splits),
            **timed(kern, ref, paged_lse_bound, paged_library, args, kw)}


# sequence-parallel decode at model 2 (part F2): shard 1's 20 query heads
# on kv heads 4-7 of one pool's 512 columns of the 32 768-token context
SP_SHARD_MODEL = (1, 20, 8, 128, 16, 512, 512)


def lse_shard_cases():
    """K1 with ``kv_heads`` and ``lse`` together, as a model shard's
    sequence-parallel decode launches it: the shard shape at a whole pool's
    length, past its end, before its start and within it under a window,
    both head ranges, and Qwen3-14B's serving shape at model 2 with a dead
    row, both dtypes."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for heads in ((4, 4), (0, 4)):
            for lens, window in (([8192], None), ([8192 + 3000], None),
                                 ([-77], None), ([900], 4096)):
                (q, ks, vs, tables, _), kw = paged_case(
                    *SP_SHARD_MODEL, window, dt, lens=[8192], kv_heads=heads)
                lens = torch.tensor(lens, dtype=torch.int32, device=DEV)
                cases.append(((q, ks, vs, tables, lens), kw))
        cases.append(paged_case(16, 20, 8, 128, 16, 69, 4416, None, dt,
                                lens=np.full(16, 1057), dead_row=True,
                                kv_heads=(4, 4)))
    return cases


def check_lse_shard() -> dict:
    """``lse_shard_cases`` against the plain version: the output within
    K1's bound, the LSE within ``LSE_TOL``, dead rows alike."""
    kern, ref = paged_lse(paged_attention), paged_lse(paged_attention_ref)
    errs = {"out": 0.0, "lse": 0.0}
    for args, kw in lse_shard_cases():
        (out, lse), (want, want_lse) = kern(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, want), max_err(lse, want_lse)
        check(e_out <= TOL["paged_attention"] and e_lse <= LSE_TOL,
              f"K1 with kv_heads {kw['kv_heads']} and lse {tuple(args[0].shape)} "
              f"lens {args[4].tolist()[:4]} {args[0].dtype}: out {e_out}, "
              f"lse {e_lse}")
        check(bool(((want_lse == NEG_INF) == (lse == NEG_INF)).all()),
              "K1's lse with kv_heads marks other rows dead")
        errs = {"out": max(errs["out"], e_out), "lse": max(errs["lse"], e_lse)}
    return {"cases": len(lse_shard_cases()), "max_abs_err_out": errs["out"],
            "max_abs_err_lse": errs["lse"], "tolerance_lse": LSE_TOL}


def phase_kernels_lse_shard() -> dict:
    """``check_lse_shard``, then timed at the SP model-shard shape."""
    out = check_lse_shard()
    args, kw = paged_case(*SP_SHARD_MODEL, None, torch.bfloat16, lens=[8192],
                          kv_heads=(4, 4))
    return {**out, **timed(paged_lse(paged_attention),
                           paged_lse(paged_attention_ref), paged_lse_bound,
                           paged_library, args, kw)}


# Qwen3-14B at model 2 over 4 KV pools (part F1): 16 rows, 4 a pool, each
# row's 69 frames in its pool of 1 104, the pools flattened
POOLED_SHARD = (16, 20, 8, 128, 16, 69, 4416)


def pooled_shard_case(dtype, dead_row=False):
    """Shard 1's 20 query heads on kv heads 4-7 of the replicated pooled
    slab, flattened [4 x 1 104, 16, 8, 128]: tables of pool-local frames
    made global by ``kvcache.gather.pooled_tables``, as
    ``attn_decode_paged_tp`` makes them."""
    (q, ks, vs, _, lens), kw = paged_case(*POOLED_SHARD, None, dtype,
                                          lens=np.full(16, 1057),
                                          kv_heads=(4, 4))
    B, _, _, _, _, MB, N = POOLED_SHARD
    f_local, per = N // POOLS, B // POOLS
    local = np.full((B, MB), -1, np.int32)
    for pool in range(POOLS):
        frames = RNG.permutation(f_local)
        for j in range(per):
            local[pool * per + j] = frames[j * MB:(j + 1) * MB]
    if dead_row:
        local[-1] = -1
    tables = kv_gather.pooled_tables(torch.from_numpy(local).to(DEV), POOLS,
                                     f_local)
    return (q, ks, vs, tables, lens), kw


def phase_kernels():
    f32, bf16 = torch.float32, torch.bfloat16
    both = (f32, bf16)
    paged = [paged_case(*row, dt) for dt in both for row in [
        (2, 8, 2, 64, 16, 8, 32, None), (3, 4, 4, 128, 16, 4, 16, None),
        (2, 16, 2, 64, 8, 16, 48, 24), (1, 4, 1, 32, 4, 4, 8, None),
        (2, 4, 2, 16, 16, 4, 8, None),          # the smoke config's head_dim
        (2, 32, 2, 64, 16, 8, 32, None),        # 16 query heads a kv head
        (2, 8, 2, 256, 16, 8, 32, None)]]       # head_dim 256: the largest kernel
    paged += [paged_case(4, 8, 2, 64, 16, 8, 32, None, dt, dead_row=True)
              for dt in both]
    flash = [flash_case(*row, dt) for dt in both for row in [
        (2, 4, 2, 128, 64, True, None), (1, 8, 8, 256, 32, True, None),
        (2, 4, 1, 128, 128, True, 64), (1, 4, 2, 256, 64, False, None),
        (2, 4, 2, 100, 16, True, None),         # ragged S, smoke head_dim
        (1, 4, 2, 333, 64, True, 100), (1, 2, 1, 70, 256, False, 33),
        (2, 40, 8, 1024, 128, True, None)]]     # full heads, short batch
    ptes = [pte_case(*row) for row in [(8, 64, 16, 2), (4, 512, 32, 9),
                                       (16, 128, 7, 0), (2, 64, 5, 3)]]
    # the fused drain: duplicates within and across the kernel's chunks,
    # entries not applied, a drain with no ids to walk
    ptes += [pte_case(8, 64, 40, 2, mutations=pte_mutations_random(8, 64, 3000, 40)),
             pte_case(4, 512, 32, 9, mutations=pte_mutations_random(4, 512, 700, 2048)),
             pte_case(8, 64, 0, 3, mutations=pte_mutations_random(8, 64, 100, 512))]
    # the shapes of the full-width serving path (Qwen3-14B, batch 16, prompt
    # 1024 + 64 generated, 4416 frames, block tables of 69 columns): checked
    # in both types, with and without a padding row, and timed in bf16
    full_paged = (16, 40, 8, 128, 16, 69, 4416, None)
    paged += [paged_case(*full_paged, dt, lens=np.full(16, 1057), dead_row=dead)
              for dt in both for dead in (False, True)]
    paged += [paged_case(*full_paged, dt) for dt in both]    # ragged lengths
    # more query heads a kv head than one block's 16: two head groups
    paged += [paged_case(2, 40, 2, 64, 16, 8, 32, None, dt) for dt in both]
    # one sequence at the model's native context (32 768 tokens, Qwen3-14B
    # widths), with and without a 4 096-token window, and ragged lengths far
    # below MB * bt in the same table width, so most splits are empty
    long_paged = (1, 40, 8, 128, 16, 2048, 2048)
    paged += [paged_case(*long_paged, win, dt, lens=[32768])
              for dt in both for win in (None, 4096)]
    paged += [paged_case(4, 40, 8, 128, 16, 2048, 2048, None, dt,
                         lens=[1, 17, 700, 5000], dead_row=dead)
              for dt in both for dead in (False, True)]
    flash += [flash_case(16, 40, 8, 1024, 128, True, None, f32)]
    # Gemma-3-4B's serving shapes (batch 16, prompt 2048 + 64 generated, 8
    # heads, 4 kv heads, head_dim 256): K1 on the global layers' slabs (8 512
    # frames, tables of 133 columns, no window), K2 on every layer, causal,
    # with the local layers' 1 024-token window and without
    gemma_paged = (16, 8, 4, 256, 16, 133, 8512, None)
    paged += [paged_case(*gemma_paged, dt, lens=np.full(16, 2112), dead_row=dead)
              for dt in both for dead in (False, True)]
    paged += [paged_case(*gemma_paged, dt) for dt in both]    # ragged lengths
    flash += [flash_case(4, 8, 4, 2048, 256, True, win, f32)
              for win in (1024, None)]
    # the MoE configs' serving shapes (batch 16, prompt 1024 + 64 generated,
    # 4 416 frames, tables of 69 columns): Qwen3-235B-A22B's 64 query heads
    # on 4 kv heads (G = 16 fills one head group of K1) and Kimi-K2's
    # head_dim 112, which both kernels run on their 128 instance with
    # columns 112-127 zero
    qwen_moe_paged = (16, 64, 4, 128, 16, 69, 4416, None)
    kimi_paged = (16, 64, 8, 112, 16, 69, 4416, None)
    # the dense configs served beside them: Nemotron-4-15B's 48 query heads
    # on 8 kv heads (G = 6) and Chameleon-34B's 64 on 8 (G = 8), head_dim 128
    nemotron_paged = (16, 48, 8, 128, 16, 69, 4416, None)
    chameleon_paged = (16, 64, 8, 128, 16, 69, 4416, None)
    for shape in (qwen_moe_paged, kimi_paged, nemotron_paged, chameleon_paged):
        paged += [paged_case(*shape, dt, lens=np.full(16, 1057), dead_row=dead)
                  for dt in both for dead in (False, True)]
        paged += [paged_case(*shape, dt, dead_row=dead)     # ragged lengths
                  for dt in both for dead in (False, True)]
    # head_dim 112 split across blocks, so that the combine's loops over
    # hd / 4 run below the kernel's 128 columns
    small_112 = (2, 8, 2, 112, 16, 64, 160, None)
    for dt in both:
        n_splits = paged_ops._plan(DEV.index, paged_ops._DTYPES[dt], 2, 8,
                                   2, 112, 64, 16, None)[1]
        check(n_splits > 1, f"head_dim 112 case runs {n_splits} split")
    paged += [paged_case(*small_112, dt, lens=lens, dead_row=dead)
              for dt in both for lens, dead in (([1000, 333], False),
                                                ([1000, 777], True))]
    flash += [flash_case(4, 64, 4, 1024, 128, True, None, f32),
              flash_case(4, 64, 8, 1024, 112, True, None, f32)]
    flash += [flash_case(B, H, 8, 1024, 128, True, None, dt)     # G = 6, 8
              for H in (48, 64) for B, dt in ((16, bf16), (4, f32))]
    flash += [flash_case(2, 8, 2, 333, 112, True, 100, dt) for dt in both]
    # Yi-6B's serving shapes (32 query heads on 4 kv heads, G = 8, head_dim
    # 128, batch 16, prompt 1 024 + 64 generated)
    yi_paged = (16, 32, 4, 128, 16, 69, 4416, None)
    paged += [paged_case(*yi_paged, dt, lens=lens, dead_row=dead)
              for dt in both for lens in (np.full(16, 1057), None)
              for dead in (False, True)]
    flash += [flash_case(B, 32, 4, 1024, 128, True, None, dt)
              for B, dt in ((16, bf16), (4, f32))]
    # Whisper-base (batch 16, 8 heads on 8 kv heads, head_dim 64): the
    # encoder's non-causal self-attention over 1 500 frames (23 full 64-row
    # tiles and 28 rows), the decoder's 4-token prompt, and K1 on the
    # decoder's slabs (384 frames, tables of 6 columns, lengths up to 4 + 64)
    whisper_paged = (16, 8, 8, 64, 16, 6, 384, None)
    paged += [paged_case(*whisper_paged, dt, lens=lens, dead_row=dead)
              for dt in both for lens in (np.full(16, 68), None)
              for dead in (False, True)]
    flash += [flash_case(4, 8, 8, 1500, 64, False, None, dt) for dt in both]
    flash += [flash_case(16, 8, 8, 4, 64, True, None, dt) for dt in both]
    # the model axis (tensor parallelism, 2 shards): K1 on one shard's kv
    # heads of the replicated slab (a head range of the contiguous slab,
    # first heads 0-4, one split and many, a dead row), K2 on a shard's
    # heads as strided views of the projection
    paged += [paged_case(*row, dt, dead_row=dead, kv_heads=heads)
              for dt in both
              for row, heads in (((16, 20, 8, 128, 16, 69, 4416, None), (4, 4)),
                                 ((16, 20, 8, 128, 16, 69, 4416, None), (0, 4)),
                                 ((2, 8, 4, 64, 16, 8, 32, None), (1, 2)),
                                 ((2, 4, 4, 64, 16, 8, 32, 24), (3, 1)),
                                 ((1, 20, 8, 128, 16, 2048, 2048, None), (4, 4)))
              for dead in (False, True)]
    paged += [paged_case(16, 20, 8, 128, 16, 69, 4416, None, dt,
                         lens=np.full(16, 1057), kv_heads=(4, 4)) for dt in both]
    flash += [flash_case(4, 20, 4, 1024, 128, True, None, dt) for dt in both]
    # the model axis over 4 KV pools: a shard's kv heads of the flattened
    # pools through pool-global tables, with and without a dead row
    paged += [pooled_shard_case(dt, dead_row=dead) for dt in both
              for dead in (False, True)]
    # RecurrentGemma-2B's local layers (10 query heads on one kv head, G =
    # 10, head_dim 256, window 2 048, prompt 4 096)
    flash += [flash_case(4, 10, 1, 4096, 256, True, 2048, dt) for dt in both]
    main = {
        "paged_attention": paged_case(16, 40, 8, 128, 16, 69, 4416, None, bf16,
                                      lens=np.full(16, 1057)),
        "paged_attention/long_context": paged_case(*long_paged, None, bf16,
                                                   lens=[32768]),
        "paged_attention/gemma3_4b": paged_case(*gemma_paged, bf16,
                                                lens=np.full(16, 2112)),
        "flash_attention": flash_case(16, 40, 8, 1024, 128, True, None, bf16),
        "flash_attention/gemma3_4b_local": flash_case(16, 8, 4, 2048, 256, True,
                                                      1024, bf16),
        "flash_attention/gemma3_4b_global": flash_case(16, 8, 4, 2048, 256, True,
                                                       None, bf16),
        "paged_attention/qwen3_moe": paged_case(*qwen_moe_paged, bf16,
                                                lens=np.full(16, 1057)),
        "paged_attention/kimi_k2": paged_case(*kimi_paged, bf16,
                                              lens=np.full(16, 1057)),
        "flash_attention/qwen3_moe": flash_case(16, 64, 4, 1024, 128, True,
                                                None, bf16),
        "flash_attention/kimi_k2": flash_case(16, 64, 8, 1024, 112, True,
                                              None, bf16),
        # the encoder runs in float32 (models/transformer.py:_encode)
        "flash_attention/whisper_encoder": flash_case(16, 8, 8, 1500, 64, False,
                                                      None, f32),
        "flash_attention/recurrentgemma_local": flash_case(
            16, 10, 1, 4096, 256, True, 2048, bf16),
        "paged_attention/whisper_decoder": paged_case(*whisper_paged, bf16,
                                                      lens=np.full(16, 68)),
        # Qwen3-14B at model = 2: shard 1's 20 query heads on kv heads 4-7
        # of the replicated slab
        "paged_attention/qwen3_14b_model_shard": paged_case(
            16, 20, 8, 128, 16, 69, 4416, None, bf16, lens=np.full(16, 1057),
            kv_heads=(4, 4)),
        "flash_attention/qwen3_14b_model_shard": flash_case(
            16, 20, 4, 1024, 128, True, None, bf16),
        # Qwen3-235B-A22B at model = 2 (the model_axis phase's part D):
        # shard 1's 32 query heads on kv heads 2-3 of the replicated slab,
        # and K2 on its 32 heads over its own 2 kv heads
        "paged_attention/qwen3_moe_model_shard": paged_case(
            16, 32, 4, 128, 16, 69, 4416, None, bf16, lens=np.full(16, 1057),
            kv_heads=(2, 2)),
        "flash_attention/qwen3_moe_model_shard": flash_case(
            16, 32, 2, 1024, 128, True, None, bf16),
        # Qwen3-14B at model = 2 over 4 KV pools (part F1): shard 1's kv
        # heads 4-7 of the pools flattened
        "paged_attention/qwen3_14b_pooled_model_shard": pooled_shard_case(bf16),
        "pte_gather": pte_case(64, 512, 16 * 69, 3, logical=np.where(
            np.arange(16 * 69) % 69 < 67,
            (np.arange(16 * 69) // 69) * 512 + np.arange(16 * 69) % 69, -1)),
    }
    serving = serving_walk_cases()
    main["pte_gather/with_mutations"] = serving["wave_switch"]
    (entries, logical, degree, _), _ = main["pte_gather"]
    no_list = walk_args(entries.cpu().numpy(), logical.cpu().numpy(), degree,
                        [np.empty(0, np.int32)] * 3 + [np.empty(0, bool)])
    ptes += [no_list, *serving.values()]
    # timed sub-dicts of a row, each also checked as a case
    subs = {"paged_attention": ["long_context", "gemma3_4b", "qwen3_moe",
                                "kimi_k2", "whisper_decoder",
                                "qwen3_14b_model_shard", "qwen3_moe_model_shard",
                                "qwen3_14b_pooled_model_shard"],
            "flash_attention": ["gemma3_4b_local", "gemma3_4b_global",
                                "qwen3_moe", "kimi_k2", "whisper_encoder",
                                "recurrentgemma_local", "qwen3_14b_model_shard",
                                "qwen3_moe_model_shard"]}
    controls = {"paged_attention": (paged_p_bf16, [None]),
                "flash_attention": (flash_p_bf16, [None, "gemma3_4b_global"])}
    spec = {
        "paged_attention": (paged_attention_ref, paged + [main["paged_attention"]],
                            paged_bound, paged_library, "paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:91"),
        "flash_attention": (flash_attention_ref, flash + [main["flash_attention"]],
                            flash_bound, flash_library, "flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:81"),
        "pte_gather": (pte_gather_ref, ptes + [main["pte_gather"]], pte_bound,
                       pte_library, "pte_gather.cu",
                       "src/repro/kernels/pte_gather/kernel.py:48"),
    }
    rows = []
    for name, (ref, cases, bound, library, source, replaces) in spec.items():
        fn = KERNEL_FNS[name]
        # the walk updates its table: both sides start from a copy, and the
        # updated tables are compared too
        check_fn, check_ref = ((pte_checked(fn), pte_checked(ref))
                               if name == "pte_gather" else (fn, ref))
        errs = {}
        cases = cases + [main[f"{name}/{sub}"] for sub in subs.get(name, [])]
        for args, kw in cases:
            got, want = check_fn(*args, **kw), check_ref(*args, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            dt = args[0].dtype
            check(err <= TOL[name],
                  f"{name} {tuple(args[0].shape)} {dt}: |err| {err} > {TOL[name]}")
            key = str(dt).replace("torch.", "")
            errs[key] = max(errs.get(key, 0.0), err)
        if name == "paged_attention":     # the combine's counters reset
            check(all(int(c.abs().sum()) == 0
                      for c, _ in paged_ops._SCRATCH.values()),
                  "paged_attention left a combine counter nonzero")
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{source}",
               "replaces": replaces, "launches": 0,
               **timed(fn, ref, bound, library, *main[name]),
               "max_abs_err_by_dtype": errs, "tolerance": TOL[name],
               "cases": len(cases)}
        for sub in subs.get(name, []):
            row[sub] = timed(fn, ref, bound, library, *main[f"{name}/{sub}"])
        if name == "paged_attention":
            row["lse"] = phase_kernels_lse()
            row["lse_model_shard"] = phase_kernels_lse_shard()
        if name == "pte_gather":
            row["coherence"] = coherence_roles()
            # the list applied again leaves the table as it is: timing the
            # walk in place repeats the same work every call
            row["with_mutations"] = {
                "mutations": int(serving["wave_switch"][0][3][0].numel()),
                **timed(fn, ref, bound, library,
                        *main["pte_gather/with_mutations"])}
            row["staging_growth"] = walk_staging_growth()
            row["rejections"] = pte_rejections()
            row["walk_device_ops_per_call"] = walk_one_launch()
        # the bf16-P control at the main shape, and for K2 once more at
        # head_dim 256
        naive, at_subs = controls.get(name, (None, []))
        for sub in at_subs:
            at = row if sub is None else row[sub]
            args, kw = main[name if sub is None else f"{name}/{sub}"]
            at["naive_p_bf16_err"] = max_err(naive(*args, **kw), ref(*args, **kw))
            check(at["naive_p_bf16_err"] > TOL[name],
                  f"rounding P to bf16 misses by {at['naive_p_bf16_err']}, "
                  f"within {TOL[name]}: the bound cannot see it")
        rows.append(row)
    rows.insert(2, phase_kernels_bwd())
    rows.extend(phase_kernels_cap())
    rows.append(phase_kernels_mla())
    return rows
