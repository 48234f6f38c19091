"""What more than one phase of the chip checks uses: the card, ``emit``,
``check``, the timer ``time_ms``, the inputs (``randn``, ``RNG``), the kernel
cases, bounds and yardsticks, the launch counters, and the serving, parity
and model-axis helpers.  Nothing draws at import: the checks draw from the
one ``RNG`` and ``DEV_GEN`` in the order ``chip_smoke.py`` runs the phases."""
import contextlib
import gc
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.fifo_miss import fifo_miss_ids
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_ref, ops as flash_ops)
from repro_torch.kernels.flash_attention.ref import visible_mask
from repro_torch.kernels.paged_attention import (ops as paged_ops, paged_attention,
                                                 paged_attention_ref)
from repro_torch.kernels.pte_gather import pte_gather, pte_gather_ref
from repro_torch.kvcache import PagedKVManager
from repro_torch.launch import analysis, specs
from repro_torch.launch.analysis import HBM_BW
from repro_torch.models import (decode_step, greedy_sample, init_decode_state,
                                layer_groups, prefill, prefill_encdec)
from repro_torch.pagedpt.blocktable import CoherenceMode


DEV = torch.device("cuda", 0)
#: the repo's root: the checks' subprocesses import ``src/repro_torch`` from it
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: FLOP/s of the card by input type (``launch/analysis.py``'s H100 peaks)
PEAK_FLOPS = {torch.bfloat16: analysis.PEAK_FLOPS,
              torch.float32: analysis.PEAK_FLOPS_F32}
# max |kernel - plain version|.  Both sides read the same inputs and work in
# float32, so bfloat16 inputs are held to the float32 bound: nothing rounds
# differently between them, and a typical output at the serving shapes is
# only about 0.05 (a looser bound would let a dropped block through).
TOL = {"paged_attention": 5e-5, "flash_attention": 1e-4, "pte_gather": 0.0}
# K1's per-row log-sum-exp against the plain one's (both float32)
LSE_TOL = 1e-5
# K2's backward: max |kernel - plain| of each of dq, dk, dv within this share
# of the plain gradient's largest magnitude (both sides float32 from the same
# inputs, bf16 ones included); a dropped 64 x 64 tile of P misses by far more
BWD_TOL_REL = 2e-5
# the model axis phase's bounds, set from readings (PERF.md, CHANGES.md):
# part A's share of compared decisions that may flip at a near-tie (a row's
# token is compared while its tokens so far are equal: with random weights
# the top logits of 151 936 lie within a bf16 step of each other often, and
# the first reading flipped 32 of 571 such decisions, 0.056, each at a
# margin of at most 2 bf16 steps), and the largest loss difference of part B
# (model 2 against 1: read 1.08e-3) and of part C (the restored run against
# the uninterrupted one: read 1.92e-4)
MAX_FLIP_SHARE = 0.1
MODEL_TRAIN_LOSS_TOL = 5e-3
ELASTIC_LOSS_TOL = 2e-3
KERNEL_FNS = {"paged_attention": paged_attention,
              "flash_attention": flash_attention,
              "flash_attention_bwd": flash_attention_bwd,
              "pte_gather": pte_gather,
              "fifo_miss": fifo_miss_ids,
              "mla_decode": paged_ops.mla_decode}
#: the wrappers whose ``softcap_launches`` count their capped instance's
#: launches; a path's counts name them "<kernel>/softcap"
CAP_FNS = {"paged_attention": paged_attention,
           "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd}
#: every count a path reads: each kernel's, and each capped instance's
COUNTED = list(KERNEL_FNS) + [f"{name}/softcap" for name in CAP_FNS]
RNG = np.random.default_rng(0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


_FLUSH = None
SLEEP_CYCLES = 4_000_000    # about 2 ms of device time at the H100's clocks


def time_ms(fn, iters: int = 10) -> float:
    """Median device time of one call, the 50 MB L2 flushed before each (in
    the serving path a layer's weights stream through between two calls).
    Each flush, event pair and call is queued behind a device-side sleep, so
    the device never waits for the host to enqueue the call it times."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        torch.cuda._sleep(SLEEP_CYCLES)
        _FLUSH.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in events]))


# the kernel checks' normal inputs, drawn on the card from seed 0: a
# full-width operand drawn on the host took seconds of the script's budget
DEV_GEN = torch.Generator(device=DEV).manual_seed(0)


def randn(shape, dtype):
    return torch.randn(tuple(shape), generator=DEV_GEN, device=DEV).to(dtype)


def make_tables(B, MB, bt, N, lens=None, dead_row=False):
    tables = np.full((B, MB), -1, np.int32)
    if lens is None:
        lens = RNG.integers(1, MB * bt, B)
    lens = np.asarray(lens, np.int32)
    perm = RNG.permutation(N)
    f = 0
    for b in range(B):
        nb = -(-int(lens[b]) // bt)
        tables[b, :nb] = perm[f:f + nb]
        f += nb
    if dead_row:
        tables[-1] = -1                       # a padding row: nothing is live
    return (torch.from_numpy(tables).to(DEV), torch.from_numpy(lens).to(DEV))


def paged_case(B, H, K, hd, bt, MB, N, window, dtype, lens=None, dead_row=False,
               kv_heads=None):
    """``kv_heads`` = (first, count): q's H heads read ``count`` of the
    slabs' K kv heads (a model shard of the replicated slab)."""
    q = randn((B, H, hd), dtype)
    ks = randn((N, bt, K, hd), dtype)
    vs = randn((N, bt, K, hd), dtype)
    tables, lens = make_tables(B, MB, bt, N, lens, dead_row)
    kw = {"window": window}
    if kv_heads is not None:
        kw["kv_heads"] = kv_heads
    return (q, ks, vs, tables, lens), kw


def paged_bound(args, kw):
    """Bytes: the live slots' K and V rows of the kv heads read, q, the
    float32 output, the tables and lengths; operations: 4 hd a live (query
    head, slot) pair."""
    q, ks, vs, tables, lens = args
    B, H, hd = q.shape
    bt = ks.shape[1]
    K = kw.get("kv_heads", (0, ks.shape[2]))[1]
    pos = torch.arange(tables.shape[1] * bt, device=DEV)[None, :]
    live = (pos < lens[:, None]) & (tables >= 0).repeat_interleave(bt, dim=1)
    if kw["window"] is not None:
        live &= pos >= lens[:, None] - kw["window"]
    n_live = int(live.sum())
    nbytes = (2 * n_live * K * hd * ks.element_size() + q.numel() * q.element_size()
              + q.numel() * 4 + tables.numel() * 4 + lens.numel() * 4)
    flops = 4 * H * hd * n_live
    return nbytes / HBM_BW, flops / PEAK_FLOPS[q.dtype]


def paged_library(args, kw):
    """Yardstick only (the port never calls it): gather the blocks (of the
    kv heads read), then SDPA."""
    q, ks, vs, tables, lens = args
    if kw.get("kv_heads") is not None:
        first, count = kw["kv_heads"]
        ks, vs = ks[:, :, first:first + count], vs[:, :, first:first + count]
    B, H, hd = q.shape
    _, bt, K, _ = ks.shape
    frames = tables.long().clamp_min(0)
    k = ks[frames].reshape(B, -1, K, hd).transpose(1, 2)
    v = vs[frames].reshape(B, -1, K, hd).transpose(1, 2)
    pos = torch.arange(k.shape[2], device=DEV)[None, :]
    mask = (pos < lens[:, None]) & (tables >= 0).repeat_interleave(bt, dim=1)
    if kw["window"] is not None:
        mask &= pos >= lens[:, None] - kw["window"]
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                          attn_mask=mask[:, None, None, :])


def flash_case(B, H, K, S, hd, causal, window, dtype):
    # [B,S,heads,hd] in memory, handed over as [B,heads,S,hd] views: the
    # layout the model's projections have
    q = randn((B, S, H, hd), dtype).transpose(1, 2)
    k = randn((B, S, K, hd), dtype).transpose(1, 2)
    v = randn((B, S, K, hd), dtype).transpose(1, 2)
    return (q, k, v), {"causal": causal, "window": window}


def flash_visible(S, causal, window):
    """[S, S] bool: may query row i see key j."""
    return visible_mask(S, causal, window, DEV)


def flash_bound(args, kw):
    q, k, v = args
    B, H, S, hd = q.shape
    flops = 4 * B * H * hd * int(flash_visible(S, **kw).sum())
    nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() + q.numel() * 4
    return nbytes / HBM_BW, flops / PEAK_FLOPS[q.dtype]


def flash_bwd_case(B, H, K, S, hd, causal, window, dtype, dout_bf16=False,
                   softcap=None):
    """The backward's inputs: q, k, v as ``flash_case`` makes them, the
    kernel forward's output and LSE (with ``softcap``, capped), and an
    output gradient, float32, or bf16-valued as the train step passes it
    (the model casts the attention output to bf16); also the forward's LSE
    error against the plain version's."""
    (q, k, v), kw = flash_case(B, H, K, S, hd, causal, window, dtype)
    out, lse = flash_ops._forward(q, k, v, causal, window, with_lse=True,
                                  softcap=softcap)
    _, want = flash_attention_ref(q, k, v, return_lse=True, softcap=softcap, **kw)
    dout = randn((B, H, S, hd), torch.float32)
    if dout_bf16:
        dout = dout.to(torch.bfloat16).float()
    return (q, k, v, out, lse, dout), kw, max_err(lse, want)


def flash_bwd_rel(got, want) -> dict:
    """max |kernel - plain| of each gradient over the plain one's largest."""
    return {name: float((g - w).abs().max() / w.abs().max())
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def flash_bwd_bound(args, kw):
    """Bytes: q, k, v in their type, O, dO and the LSE read, dq, dk, dv
    written (float32); operations: 2.5x the forward's 4 hd a visible pair."""
    q, k, v, out, lse, dout = args
    B, H, S, hd = q.shape
    flops = 2.5 * 4 * B * H * hd * int(flash_visible(S, **kw).sum())
    nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
              + (out.numel() + dout.numel() + lse.numel()) * 4
              + (q.numel() + k.numel() + v.numel()) * 4)
    return nbytes / HBM_BW, flops / PEAK_FLOPS[q.dtype]


# Yi-6B's training shape (batch 8, seq 1 024, 32 heads on 4 kv heads)
FLASH_BWD_TRAIN = (8, 32, 4, 1024, 128, True, None)
# Gemma 2's published attn_logit_softcapping
SOFTCAP = 50.0


def paged_lse(fn):
    """``fn`` (the kernel's wrapper or the plain version) returning (out,
    lse [B,H]); keywords (``window``, ``kv_heads``) passed on."""
    def run(q, ks, vs, tables, lens, **kw):
        if fn is paged_attention:
            lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
            return fn(q, ks, vs, tables, lens, lse=lse, **kw), lse
        return fn(q, ks, vs, tables, lens, return_lse=True, **kw)
    return run


def paged_lse_bound(args, kw):
    t_bytes, t_ops = paged_bound(args, kw)
    return t_bytes + args[0].shape[0] * args[0].shape[1] * 4 / HBM_BW, t_ops


# the sequence-parallel shard of one 32 768-token Qwen3-14B context over 4
# shards: 512 of its 2 048 block-table columns
SP_SHARD = (1, 40, 8, 128, 16, 512, 512)


def lse_cases():
    """K1 with the LSE: the shard shape at a whole shard's length, past its
    end and before its start (the shard-local length of a shard wholly
    before or after the row: min(c_end * bt, len) and a length <= 0 leave
    no live slot), with a window across the shard's first position, one
    split and many, the serving shape with a dead row, both dtypes."""
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for lens, window in (([8192], None), ([8192 + 3000], None), ([-77], None),
                             ([0], None), ([900], 4096), ([8192 + 2000], 4096),
                             ([9000], 4096)):
            (q, ks, vs, tables, _), kw = paged_case(*SP_SHARD, window, dt,
                                                    lens=[8192])
            lens = torch.tensor(lens, dtype=torch.int32, device=DEV)
            cases.append(((q, ks, vs, tables, lens), kw))
        cases.append(paged_case(4, 8, 2, 64, 16, 8, 32, None, dt, dead_row=True))
        cases.append(paged_case(16, 40, 8, 128, 16, 69, 4416, None, dt,
                                lens=np.full(16, 1057), dead_row=True))
        cases.append(paged_case(1, 40, 8, 128, 16, 2048, 2048, None, dt,
                                lens=[32768]))
    return cases


def max_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    if not got.dtype.is_floating_point:
        return float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    return float((got.float() - want.float()).abs().max())


def timed(fn, ref, bound, library, args, kw):
    """Error, times and bound of one kernel at one shape."""
    t_bytes, t_ops = bound(args, kw)
    return {"max_abs_err": max_err(fn(*args, **kw), ref(*args, **kw)),
            "ms": time_ms(lambda: fn(*args, **kw)),
            "plain_ms": time_ms(lambda: ref(*args, **kw)),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lambda: library(args, kw)),
            "timed_shape": [list(a.shape) for a in args if torch.is_tensor(a)]}


def release() -> None:
    """Hand the card's memory that the previous arch's weights held back to
    the allocator, so that the next arch's 35-48 GB find it in one piece."""
    gc.collect()
    torch.cuda.empty_cache()


def reset_counters() -> None:
    for fn in KERNEL_FNS.values():
        fn.launches = 0
    for fn in CAP_FNS.values():
        fn.softcap_launches = 0


def counts_now() -> dict:
    """The launches of each kernel, and of each capped instance under
    "<kernel>/softcap", since the counters were zeroed."""
    return {**{name: fn.launches for name, fn in KERNEL_FNS.items()},
            **{f"{name}/softcap": fn.softcap_launches
               for name, fn in CAP_FNS.items()}}


def uncapped(want: dict) -> dict:
    """``want`` of a path that launches no capped instance (and no K4 where
    ``want`` names none)."""
    return {"mla_decode": 0, **want,
            **{f"{name}/softcap": 0 for name in CAP_FNS}}


# the KV pools of the model axis's pooled parts (the kernels' pooled shard, F1)
POOLS = 4
# Whisper-base's serve: 1 500 encoder frames (30 s of audio; the frontend is a
# stub in the reference too), a 4-token decoder prompt (start of transcript)
WHISPER = dict(batch=16, enc_len=1500, prompt_len=4, gen_len=64, n_requests=32)


def attention_layers(cfg):
    """(global attention layers, attention layers) of ``cfg``."""
    groups = layer_groups(cfg)
    n_global = sum(g.n_layers for g in groups
                   if g.kind in ("attn", "dec_attn") and g.window is None)
    n_attn = sum(g.n_layers for g in groups
                 if g.kind in ("attn", "enc_attn", "dec_attn"))
    return n_global, n_attn


def expected_launches(cfg, waves: int, gen_len: int, warm_up: bool,
                      shards: int = 1) -> dict:
    """The kernel launches ``waves`` waves of the path make, from the
    config's layer groups: K1 once a decode step in each global attention
    layer (a local layer decodes from its ring, a recurrent one from its
    state), K2 once a prefill in each attention layer, K3 once a walk (a
    wave's first walk, one a decode step, and the sync of
    ``check_device_table`` after the frees).  Latent attention (``cfg.mla``)
    decodes on K4 where the others decode on K1.  ``warm_up``: serve()'s
    warm-up prefill and decode step add one launch a layer each.
    ``shards``: the model shards each attention layer's heads split over (K1
    and K2 launch once a shard; 1 where the attention runs replicated)."""
    n_global, n_attn = attention_layers(cfg)
    extra = 1 if warm_up else 0
    decode = n_global * (gen_len * waves + extra) * shards
    return uncapped({"paged_attention": 0 if cfg.mla else decode,
                     "mla_decode": decode if cfg.mla else 0,
                     "flash_attention": n_attn * (waves + extra) * shards,
                     "flash_attention_bwd": 0,
                     "pte_gather": (2 + gen_len) * waves, "fifo_miss": 0})


@contextlib.contextmanager
def lse_pointers_counted(into: dict):
    """Count K2 forward launches that write the LSE (a non-null ``lse``
    argument) into ``into["lse_writes"]``, by wrapping the launcher the
    wrapper looks up.  Serving must write none, training one a launch."""
    real = flash_ops._launcher
    into["lse_writes"] = 0

    def launcher():
        fn = real()

        def counted(*args):
            into["lse_writes"] += args[4] is not None
            return fn(*args)
        return counted

    flash_ops._launcher = launcher
    try:
        yield into
    finally:
        flash_ops._launcher = real


@torch.no_grad()
def whisper_serve(cfg, params, *, batch, enc_len, prompt_len, gen_len,
                  n_requests, n_pods=4, mode="numapte", seed=0, grid=None,
                  keep_logits=False):
    """The encoder-decoder's serving loop, the counterpart of serve() (which
    takes decoder-only configs, as the reference's does): waves of
    ``batch`` requests, each a clip of ``enc_len`` frame embeddings drawn
    from a seeded generator and a decoder prompt, through the reference's
    entry points ``prefill_encdec`` and ``decode_step`` over a
    PagedKVManager's tables (start, walk, extend, finish, the invariants and
    the device table checked after each wave).  The first decode step takes
    the prefill's greedy token.  No warm-up: the kernels are built and the
    GEMM library warm by the time this runs.  ``grid``: its model axis runs
    the model (``params`` split over it, the caches as its rules place
    them) and its data axis the rows (``prefill_encdec_on_grid`` /
    ``decode_on_grid``: each shard's cross K/V rows its own);
    ``keep_logits`` adds every step's logits (``logits``, a list on the
    card)."""
    tp = None if grid is None or grid.model.n == 1 else grid.model
    bt = cfg.kv_block_tokens
    max_blocks = -(-(prompt_len + gen_len) // bt) + 1
    n_frames = batch * max_blocks * 4
    kv = PagedKVManager(n_frames=n_frames, block_tokens=bt,
                        max_blocks_per_seq=max_blocks, n_pods=n_pods,
                        mode=CoherenceMode(mode), device=DEV)
    state = init_decode_state(
        cfg, batch, n_frames, max_blocks, enc_len=enc_len, device=DEV,
        kv_split=1 if tp is None else specs.kv_split(cfg, grid))
    gen = torch.Generator(device=DEV).manual_seed(seed)
    kept = []
    rng = np.random.default_rng(seed)
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    sampled, prefill_s, decode_s, waves = [], [], [], 0
    t0 = time.perf_counter()
    for first in range(0, n_requests, batch):
        wave = list(range(first, min(first + batch, n_requests)))
        active = wave + [-1] * (batch - len(wave))
        for i, sid in enumerate(wave):
            kv.start_sequence(sid, prompt_len, pod=i % n_pods)
        feats = torch.randn((batch, enc_len, cfg.d_model), generator=gen,
                            device=DEV).to(cfg.dtype)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (batch, prompt_len))).to(DEV)
        t_wave = time.perf_counter()
        phys = kv.physical_tables(active)
        logits, st = (prefill_encdec(cfg, params, feats, prompts, state, phys,
                                     tp=tp) if grid is None else
                      specs.prefill_encdec_on_grid(cfg, params, feats, prompts,
                                                   state, phys, grid))
        torch.cuda.synchronize()
        t_prefilled = time.perf_counter()
        finite &= torch.isfinite(logits[:len(wave)]).all()
        tokens = greedy_sample(logits)
        steps = []
        for t in range(gen_len):
            for sid in wave:
                kv.maybe_extend(sid, prompt_len + t + 1)
            phys = kv.physical_tables(active, record=(t % 4 == 0))
            logits, st = (decode_step(cfg, params, st, tokens, phys, tp=tp)
                          if grid is None else
                          specs.decode_on_grid(cfg, params, st, tokens, phys,
                                               grid))
            if keep_logits:
                kept.append(logits)
            finite &= torch.isfinite(logits[:len(wave)]).all()
            tokens = greedy_sample(logits)
            steps.append(tokens)
        torch.cuda.synchronize()
        prefill_s.append(t_prefilled - t_wave)
        decode_s.append(time.perf_counter() - t_prefilled)
        waves += 1
        sampled.append(torch.stack(steps, dim=1)[:len(wave)].cpu().numpy())
        for sid in wave:
            kv.finish_sequence(sid)
        kv.host.check_invariants()
        kv.check_device_table()
    dt = time.perf_counter() - t0
    c = kv.host.counters
    return {"mode": mode, "n_pods": n_pods, "tokens": n_requests * gen_len,
            "tok_per_s": n_requests * gen_len / dt,
            "invalidations_sent": c.invalidations_sent,
            "invalidations_filtered": c.invalidations_filtered,
            "coherence_bytes": c.coherence_bytes, "fetches": c.fetches,
            "prefetched": c.prefetched, "table_pages": kv.footprint_pages(),
            "prefill_ms": 1e3 * sum(prefill_s) / waves,
            "prefill_ms_by_wave": [1e3 * x for x in prefill_s],
            "decode_step_ms": 1e3 * sum(decode_s) / (waves * gen_len),
            "decode_step_ms_by_wave": [1e3 * x / gen_len for x in decode_s],
            "logits_finite": bool(finite), "token_ids": np.concatenate(sampled),
            **({"logits": kept} if keep_logits else {})}


@contextlib.contextmanager
def plain_versions():
    """Route the model and the page walk through the plain PyTorch versions
    (on the card), by swapping the names the path looks up."""
    from repro_torch.kvcache import manager
    from repro_torch.models import attention
    saved = (attention.flash_attention, attention.paged_attention,
             manager.pte_gather)
    attention.flash_attention = flash_attention_ref
    attention.paged_attention = paged_attention_ref
    manager.pte_gather = pte_gather_ref
    try:
        yield
    finally:
        (attention.flash_attention, attention.paged_attention,
         manager.pte_gather) = saved


@contextlib.contextmanager
def routes_recorded(into: list, follow=None, per_call: int = 1):
    """Append the routes (``moe.Routes``: probabilities, expert ids [N, k])
    that each MoE call of the model picks, in call order, by wrapping the
    name ``moe_forward`` looks up, as ``plain_versions`` swaps the kernels.
    With ``follow`` (the routes another run recorded) each call takes that
    run's expert ids instead of its own, its gates renormalised from its own
    probabilities; ``into`` still gets its own picks.  ``per_call``: the
    routes one MoE call picks (one a local model shard, each of them
    following the same call of ``follow``)."""
    from repro_torch.models import moe
    real = moe.route

    def recording(cfg, p, xf, logits=None):
        own = real(cfg, p, xf, logits=logits)
        into.append(own)
        if follow is None:
            return own
        eids = follow[(len(into) - 1) // per_call].eids
        gates = own.probs.gather(1, eids)
        return moe.Routes(own.probs, eids, gates / gates.sum(-1, keepdim=True))

    moe.route = recording
    try:
        yield
    finally:
        moe.route = real


def route_agreement(mine: list, theirs: list) -> dict:
    """The share of (token, layer, k) expert ids of ``mine`` equal to those
    of ``theirs``, and the largest relative probability gap, under ``mine``'s
    probabilities, between an expert one side took and the other left (a
    near-tie below ``moe.NEAR_TIE``)."""
    from repro_torch.models import moe
    check(len(mine) == len(theirs) > 0, "no MoE call recorded")
    same = total = 0
    gap = 0.0
    for a, b in zip(mine, theirs):
        same += int((a.eids == b.eids).sum())
        total += a.eids.numel()
        gap = max(gap, moe.route_flips(a.probs, a.eids, b.eids)[1])
    return {"route_agreement": same / total, "routes_compared": total,
            "largest_gap": gap}


def first_wave(cfg, params, batch, prompt_len, steps):
    """Prefill one wave and take ``steps`` decode steps on tokens drawn from
    a seed (the same whichever path runs); the logits of each, float32.  An
    encoder-decoder prefills through ``prefill_encdec`` on WHISPER's number
    of frame embeddings, drawn from a seed too."""
    bt = cfg.kv_block_tokens
    max_blocks = -(-(prompt_len + steps) // bt) + 1
    kv = PagedKVManager(n_frames=batch * max_blocks, block_tokens=bt,
                        max_blocks_per_seq=max_blocks, n_pods=4,
                        mode=CoherenceMode.NUMAPTE, device=DEV)
    enc_len = WHISPER["enc_len"] if cfg.family == "encdec" else 0
    state = init_decode_state(cfg, batch, kv.n_frames, max_blocks,
                              enc_len=enc_len, device=DEV)
    ids = list(range(batch))
    for i in ids:
        kv.start_sequence(i, prompt_len, pod=i % 4)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt_len + steps))).to(DEV)
    if cfg.family == "encdec":
        feats = torch.randn((batch, enc_len, cfg.d_model), device=DEV,
                            generator=torch.Generator(device=DEV).manual_seed(1))
        logits, st = prefill_encdec(cfg, params, feats.to(cfg.dtype),
                                    tokens[:, :prompt_len], state,
                                    kv.physical_tables(ids))
    else:
        logits, st = prefill(cfg, params, tokens[:, :prompt_len], state,
                             kv.physical_tables(ids))
    out = [logits.float()]
    for t in range(steps):
        for i in ids:
            kv.maybe_extend(i, prompt_len + t + 1)
        logits, st = decode_step(cfg, params, st, tokens[:, prompt_len + t],
                                 kv.physical_tables(ids))
        out.append(logits.float())
    return out


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# the pod axis's part B and the model axis's F2: one Qwen3-14B context of
# 32 768 tokens (its native length), 4 shards; a token may flip at a
# near-tie, in at most an eighth of the steps
SP = dict(context=32768, steps=32, shards=4, max_flips=4)


def sp_context(cfg, params):
    """``SP``'s context prefilled into a one-pool state through the walk (the
    launch counters zeroed before it), then each column's frame copied into
    the pool that sequence-parallel decode reads (harness code: the
    reference has no prefill for that layout, ROADMAP queue 3).  Returns
    (kv, phys, the one-pool state, the prefill's logits, the SP state, the
    SP decode's pool-local tables)."""
    bt, n = cfg.kv_block_tokens, SP["shards"]
    MB = SP["context"] // bt
    MBl = MB // n
    kv = PagedKVManager(n_frames=MB, block_tokens=bt, max_blocks_per_seq=MB,
                        n_pods=n, device=DEV)
    kv.start_sequence(0, SP["context"])
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, SP["context"] - SP["steps"]))).to(DEV, torch.int32)
    reset_counters()
    phys = kv.physical_tables([0])                     # [1, 2048]
    one = init_decode_state(cfg, 1, MB, MB)
    logits, one = prefill(cfg, params, prompt, one, phys)
    sp = init_decode_state(cfg, 1, MB, MB, n_pools=n)
    for name in ("k_slabs", "v_slabs"):
        for s in range(n):
            sp.caches[0][name][:, s] = \
                one.caches[0][name][:, phys[0, s * MBl:(s + 1) * MBl].long()]
    local = (torch.arange(MB, device=DEV) % MBl).to(torch.int32)[None]
    return kv, phys, one, logits, sp._replace(seq_lens=one.seq_lens.clone()), local


# A: Qwen3-14B (all 40 layers) served at model = 2 on one pod, the serve
# phase's traffic, against model = 1 on the same weights and prompts
MODEL_SERVE = dict(batch=16, prompt_len=1024, gen_len=64, n_requests=32,
                   n_pods=1, mode="numapte", model=2, top_k=8,
                   max_flip_share=MAX_FLIP_SHARE)


def first_flips(ids1, ids2, top1, top2):
    """For each row whose tokens differ: the first step where they do, the
    two tokens and model = 1's margin between them (its logit of its own
    token less its logit of the other's, from its top-k), and each run's
    logit of both tokens where its top-k holds them.  After that step a row
    continues from another token, so only its first flip is a comparison."""
    (v1, i1), (v2, i2) = top1, top2
    flips = []
    for r in np.nonzero((ids1 != ids2).any(axis=1))[0]:
        s = int(np.argmax(ids1[r] != ids2[r]))
        a, b = int(ids1[r, s]), int(ids2[r, s])
        pick = lambda v, i, tok: (float(v[r, s][i[r, s] == tok][0])
                                  if (i[r, s] == tok).any() else None)
        one_b = pick(v1, i1, b)
        flips.append({"row": int(r), "step": s, "token_model1": a,
                      "token_model2": b,
                      "margin_model1": (None if one_b is None
                                        else float(v1[r, s, 0]) - one_b),
                      "model1_logits": [float(v1[r, s, 0]), one_b],
                      "model2_logits": [pick(v2, i2, a), float(v2[r, s, 0])]})
    return flips


# D: the other families served at model = 2 against model = 1 on the same
# seeded bf16 weights, at published widths and MODEL_SERVE's traffic (one
# pod); the depth each is served at (None: all its layers): Qwen3-MoE and
# Kimi-K2 at their serve phase's cut (the whole tree is split leaf by leaf,
# so the card never holds it twice).  Whisper-base through whisper_serve at
# WHISPER's traffic.
# Mamba-2 is held in float32 (family_serve): in bf16 its random-weight
# model amplifies a change in the order of the roundings past the bound (its
# line reads model 1 in bf16 against itself in float32 beside model 2's).
FAMILIES = dict(archs={"gemma3_4b": None, "mamba2_370m": None,
                       "recurrentgemma_2b": None, "qwen3_moe_235b_a22b": 8,
                       "kimi_k2_1t_a32b": 2},
                model=2, top_k=8, max_flip_share=MAX_FLIP_SHARE,
                held_in_float32=("mamba2_370m",))


def shard_in_place(params, grid, cfg):
    """``specs.shard_params`` of ``params`` over ``grid``'s model axis, in
    place, leaf by leaf: each whole leaf is let go as soon as its shards are
    stacked."""
    shards = specs.param_shardings(params, grid, cfg)

    def walk(node, shard):
        for k in (list(node) if isinstance(node, dict) else range(len(node))):
            if isinstance(node[k], (dict, list)):
                walk(node[k], shard[k])
            elif shard[k] is not None:
                node[k] = specs.shard_leaf(node[k], shard[k], grid.model)

    walk(params, shards)
    return params


def heads_shards(params, t: int) -> int:
    """t when the attention layers' heads are split over the model axis
    (K1 and K2 launched once a shard), else 1."""
    split = [lp["attn"]["wq"].dim() == 3 for gp in params["groups"]
             for lp in gp if "attn" in lp]
    check(len(set(split)) <= 1, "attention split in some layers only")
    return t if split and split[0] else 1


def held_to_model_one(arch, one, two, t, gen_len, what=None) -> dict:
    """The first decode step's logits of model = t against model = 1's, and
    the first flip of each row whose tokens differ: each must be at a
    near-tie, model = 1's margin between the two tokens no larger than
    twice the first step's largest logit difference (each of the two logits
    moves by up to it), and the flips at most ``max_flip_share`` of the
    compared decisions.  ``what`` names the run held (default model t)."""
    what = what or f"model {t}"
    first_err = float(np.abs(two["first_logits"] - one["first_logits"]).max())
    first_rel = first_err / float(np.abs(one["first_logits"]).max())
    noise = 2 * first_err
    flips = first_flips(one["token_ids"], two["token_ids"],
                        (one["top_values"], one["top_ids"]),
                        (two["top_values"], two["top_ids"]))
    at_tie = [f["margin_model1"] is not None and f["margin_model1"] <= noise
              for f in flips]
    equal_rows = int((one["token_ids"] == two["token_ids"]).all(axis=1).sum())
    compared = int(sum(f["step"] + 1 for f in flips) + equal_rows * gen_len)
    check(first_rel <= 0.03, f"{arch} {what}: first-step logits rel {first_rel}")
    check(all(at_tie) and len(flips) <= FAMILIES["max_flip_share"] * compared,
          f"{arch} {what}: token flips {flips} in {compared} compared "
          f"decisions (at most a share {FAMILIES['max_flip_share']}, each at "
          f"a margin <= {noise})")
    return {"first_step_logits_rel_err": first_rel,
            "first_step_logits_max_abs_err": first_err,
            "near_tie_margin": noise,
            "rows_token_equal": equal_rows, "decisions_compared": compared,
            "flips": len(flips), "flip_share": len(flips) / compared,
            "flip_margins_model1": sorted(f["margin_model1"] for f in flips),
            "first_flips": flips}


SERVE_KEEP = ("prefill_ms", "decode_step_ms", "tok_per_s", "peak_mem_gb",
              "model_wire_bytes_per_step", "model_calls", "kv_layout",
              "launches", "heads_shards", "fetches")
