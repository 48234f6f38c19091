#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py                  # every phase, needs one CUDA device
    python3 chip_smoke.py --phases kernels # build + kernel checks only
    python3 chip_smoke.py --phases profile # where a decode step's time goes

Phases (each prints one JSON object on a line of its own; any failure raises
and the script exits non-zero):

  device    card name and power limit (nvidia-smi), build of the CUDA kernels
  kernels   each hand-written kernel against its plain PyTorch version on the
            card, at the reference's test shapes and at the full-width shapes
            of the serving paths (Qwen3-14B at head_dim 128, Gemma-3-4B at
            head_dim 256, K2 with and without Gemma's window, Qwen3-235B-A22B
            at 16 query heads a kv head, Kimi-K2 at head_dim 112, Yi-6B,
            Whisper's non-causal encoder over 1 500 frames and its decoder at
            G = 1, head_dim 64, RecurrentGemma's 10 query heads on one kv head
            with its 2 048 window); timed against the plain version, a
            PyTorch library call and the card's bound.
            The page walk (K3) is checked with the serving path's mutation
            lists too (a wave's allocations, a wave switch, an entry not
            applied), bit-exact, the updated table included; through the
            manager with lists that outgrow its first staging buffer; and on
            arguments it must refuse
  serve     each arch at its published widths served through
            the numaPTE paged-KV path (random weights from a seed): Qwen3-14B
            (global layers, depth ``--layers``), Gemma-3-4B (all 34
            layers: 29 local layers decode from ring caches, 5 global layers
            through the block table), the mixture-of-experts configs
            Qwen3-235B-A22B (8 of 94 layers) and Kimi-K2 (2 of 61: its dense
            first layer and one MoE layer), Nemotron-4-15B (all 32),
            Chameleon-34B (24 of 48), Yi-6B (all 32), Mamba-2-370M (all 48
            SSD layers: no attention, the block table is walked all the same)
            and RecurrentGemma-2B (all 26: 18 RG-LRU layers, 8 local
            attention layers on rings), then Whisper-base (all 12 layers)
            through ``whisper_serve``: ``prefill_encdec`` and ``decode_step``
            over the manager's tables.  The launch counters of the three
            kernels are zeroed before each and read after, and must equal
            what the arch's layer groups imply (zero for a kernel it has no
            layer for)
  parity    the same widths at a cut depth, per arch: kernel path against
            plain path (bf16 logits, float32 token ids where the weights fit
            in float32, and for the MoE configs the share of expert ids that
            agree), and the three coherence modes against each other;
            Mamba-2, whose model path runs no kernel, instead holds prefill +
            one decode step against forward_lm in float32 at a ragged prompt
  coherence the port's serving_coherence benchmark (three modes of
            Qwen3-14B at published widths, 4 layers, and the budget row)
  profile   (only when asked for) the serving loop of Qwen3-14B, Gemma-3-4B,
            Qwen3-235B-A22B (its serve depth), Mamba-2-370M and
            RecurrentGemma-2B under ``torch.profiler`` at two generation
            lengths: their difference gives the device-busy time, the kernel
            launches and the largest kernels of one decode step, and the
            shorter run less its decode steps those of one prefill; the
            step's wall time comes from a run
            without the profiler; and the device operations of one page walk
            of each kind (a wave's first walk, an extension step, a steady
            step, the sync after the frees), which must be one kernel and one
            copy

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import NEG_INF  # noqa: E402
from repro_torch.kernels.paged_attention import (paged_attention,  # noqa: E402
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.pte_gather import pte_gather, pte_gather_ref  # noqa: E402
from repro_torch.kvcache import PagedKVManager  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import (active_param_count,  # noqa: E402
                                decode_step, forward_lm, greedy_sample,
                                init_decode_state, init_params, layer_groups,
                                param_count, prefill, prefill_encdec)
from repro_torch.pagedpt.blocktable import (CoherenceMode,  # noqa: E402
                                            apply_mutations)

DEV = torch.device("cuda", 0)
# published peaks of one H100 SXM (dense): bytes/s of HBM, FLOP/s by input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# max |kernel - plain version|.  Both sides read the same inputs and work in
# float32, so bfloat16 inputs are held to the float32 bound: nothing rounds
# differently between them, and a typical output at the serving shapes is
# only about 0.05 (a looser bound would let a dropped block through).
TOL = {"paged_attention": 5e-5, "flash_attention": 1e-4, "pte_gather": 0.0}
KERNEL_FNS = {"paged_attention": paged_attention,
              "flash_attention": flash_attention, "pte_gather": pte_gather}
RNG = np.random.default_rng(0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------- timing
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


# --------------------------------------------------------------------- inputs
def randn(shape, dtype):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(
        device=DEV, dtype=dtype)


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


# ----------------------------------------------------------- paged attention
def paged_case(B, H, K, hd, bt, MB, N, window, dtype, lens=None, dead_row=False):
    q = randn((B, H, hd), dtype)
    ks = randn((N, bt, K, hd), dtype)
    vs = randn((N, bt, K, hd), dtype)
    tables, lens = make_tables(B, MB, bt, N, lens, dead_row)
    return (q, ks, vs, tables, lens), {"window": window}


def paged_bound(args, kw):
    q, ks, vs, tables, lens = args
    B, H, hd = q.shape
    _, bt, K, _ = ks.shape
    pos = torch.arange(tables.shape[1] * bt, device=DEV)[None, :]
    live = (pos < lens[:, None]) & (tables >= 0).repeat_interleave(bt, dim=1)
    if kw["window"] is not None:
        live &= pos >= lens[:, None] - kw["window"]
    n_live = int(live.sum())
    nbytes = (2 * n_live * K * hd * ks.element_size() + q.numel() * q.element_size()
              + q.numel() * 4 + tables.numel() * 4 + lens.numel() * 4)
    flops = 4 * H * hd * n_live
    return nbytes / HBM_BPS, flops / PEAK_FLOPS[q.dtype]


def paged_library(args, kw):
    """Yardstick only (the port never calls it): gather the blocks, then SDPA."""
    q, ks, vs, tables, lens = args
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


# ----------------------------------------------------------- flash attention
def flash_case(B, H, K, S, hd, causal, window, dtype):
    # [B,S,heads,hd] in memory, handed over as [B,heads,S,hd] views: the
    # layout the model's projections have
    q = randn((B, S, H, hd), dtype).transpose(1, 2)
    k = randn((B, S, K, hd), dtype).transpose(1, 2)
    v = randn((B, S, K, hd), dtype).transpose(1, 2)
    return (q, k, v), {"causal": causal, "window": window}


def flash_visible(S, causal, window):
    """[S, S] bool: may query row i see key j."""
    i = torch.arange(S, device=DEV)
    vis = torch.ones((S, S), dtype=torch.bool, device=DEV)
    if causal:
        vis &= i[:, None] >= i[None, :]
    if window is not None:
        vis &= (i[:, None] - i[None, :]) < window
    return vis


def flash_bound(args, kw):
    q, k, v = args
    B, H, S, hd = q.shape
    flops = 4 * B * H * hd * int(flash_visible(S, **kw).sum())
    nbytes = (q.numel() + k.numel() + v.numel()) * q.element_size() + q.numel() * 4
    return nbytes / HBM_BPS, flops / PEAK_FLOPS[q.dtype]


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


# ---------------------------------------------------------------- pte gather
def walk_args(entries, logical, degree, mutations=None):
    """Args (entries, logical, degree, mutations) of the walk on the card;
    mutations None or (table, idx, value [n] int32, applied [n] bool)."""
    if mutations is not None:
        mutations = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
                          for a in mutations)
    return (torch.from_numpy(entries).to(DEV),
            torch.from_numpy(np.asarray(logical, np.int32)).to(DEV),
            degree, mutations), {}


def pte_case(T, epb, M, degree, logical=None, mutations=None):
    entries = np.full((T, epb), -1, np.int32)
    mask = RNG.random((T, epb)) > 0.4
    entries[mask] = (RNG.integers(0, 1 << 20, mask.sum()) | (3 << 28)).astype(np.int32)
    if logical is None:
        logical = RNG.integers(-2, T * epb + 2, M)
    return walk_args(entries, logical, degree, mutations)


def pte_checked(fn):
    """Run the walk on a copy of the table and return the updated table
    beside the outputs, so kernel and plain version start from one table."""
    def run(entries, logical, degree, mutations=None):
        table = entries.clone()
        return (*fn(table, logical, degree, mutations), table)
    return run


def pte_mutations_random(T, epb, n, n_slots):
    """n mutations over the first n_slots slots (many duplicates, across the
    kernel's 1 024-mutation chunks), a quarter not applied."""
    slots = RNG.integers(0, n_slots, n)
    value = (RNG.integers(0, 1 << 20, n) | (3 << 28)).astype(np.int32)
    value[RNG.random(n) < 0.3] = -1
    return ((slots // epb).astype(np.int32), (slots % epb).astype(np.int32),
            value, RNG.random(n) > 0.25)


def drain_all(host):
    """Every pending drain of a host manager, concatenated in order, as
    ``PagedKVManager`` stages them for one walk (kept here rather than taken
    from the manager, so that ``tools/walk_compare.py`` can drive a checkout
    from before the fused walk with the same inputs)."""
    drains = []
    while True:
        table, idx, value, valid = host.drain_mutation_buffer()
        n = int(valid.sum())
        if n == 0:
            return [np.concatenate(c) for c in zip(*drains)]
        drains.append((table[:n], idx[:n], value[:n], valid[:n]))


# the serving path's page walks (Qwen3-14B served at batch 16, prompt 1024 +
# 64 generated, 4 pods, numaPTE), as serve() sizes its manager
WALK_SHAPE = dict(n_frames=16 * 69 * 4, block_tokens=16, max_blocks_per_seq=69,
                  n_pods=4, mode=CoherenceMode.NUMAPTE)


def serving_walk_cases():
    """The page walk's inputs on the serving path (Qwen3-14B served at batch
    16, prompt 1024 + 64 generated, 4 pods, numaPTE: 4 416 frames, tables of
    69 columns, 64 table pages of 512 entries, d = 3): a wave's first walk
    with its 1 024 allocations; a wave switch, the 1 088 frees of one wave
    followed by the next wave's 1 024 allocations, which reuse the freed
    slots, so that duplicates cross drains; the same with one entry not
    applied that names a live slot."""
    kv = PagedKVManager(**WALK_SHAPE, device=DEV)
    host, d = kv.host, kv.spec.prefetch_degree
    ids = list(range(16))
    empty = host.canonical.copy()
    for i in ids:
        kv.start_sequence(i, 1024, pod=i % 4)
    allocs = drain_all(host)
    first = walk_args(empty, kv.logical_tables(ids).reshape(-1), d, allocs)
    for i in ids:
        kv.maybe_extend(i, 1024 + 64)
    drain_all(host)
    before = host.canonical.copy()
    for i in ids:
        kv.finish_sequence(i)
    ids = list(range(16, 32))
    for i in ids:
        kv.start_sequence(i, 1024, pod=i % 4)
    switch = drain_all(host)
    logical = kv.logical_tables(ids).reshape(-1)
    check(len(allocs[0]) == 1024 and len(switch[0]) == 1088 + 1024,
          f"mutations {len(allocs[0])}, {len(switch[0])}")
    check(len(np.unique(switch[0] * 512 + switch[1])) < len(switch[0]),
          "the wave switch names no slot twice")
    live = int(np.flatnonzero(logical >= 0)[0])
    masked = [np.append(c, np.array(x, c.dtype)) for c, x in zip(
        switch, (logical[live] // 512, logical[live] % 512, 12345, False))]
    return {"first_walk": first,
            "wave_switch": walk_args(before, logical, d, switch),
            "masked_live_slot": walk_args(before, logical, d, masked)}


def pte_bound(args, kw):
    entries, logical, degree, mutations = args
    M, W = logical.numel(), 1 << degree
    # in: the id and the W entries of its window; out: frame, flag, window
    nbytes = M * (4 + 4 * W + 4 + 1 + 4 * W)
    if mutations is not None:
        table, idx, _, applied = mutations
        # 13 bytes a mutation read, 4 written for each slot an applied one names
        slots = (table.long() * entries.shape[1] + idx.long())[applied]
        nbytes += 13 * table.numel() + 4 * int(slots.unique().numel())
    return nbytes / HBM_BPS, 0.0


def pte_library(args, kw):
    """Yardstick only (the port never calls it): the port's PyTorch
    ``apply_mutations`` where there is a list, then the window as one tensor
    indexing call (the walk's own entry is a column of it)."""
    entries, logical, degree, mutations = args
    if mutations is not None:
        apply_mutations(entries, *mutations)
    T, epb = entries.shape
    W = 1 << degree
    lg = logical.long()
    tid = (lg // epb).clamp(0, T - 1)
    start = (lg % epb - W // 2).clamp(0, epb - W)
    cols = start[:, None] + torch.arange(W, device=DEV)[None, :]
    return entries[tid[:, None], cols]


def pte_rejections():
    """Arguments the kernel cannot take fail: the launch refuses a window
    wider than a page with cudaErrorInvalidValue (whatever the wrapper
    checks), and a mutation naming a slot outside the table fails a device
    assert (in a process of its own: the error ends its CUDA context)."""
    from repro_torch.kernels.pte_gather import ops
    e = torch.full((4, 64), -1, dtype=torch.int32, device=DEV)
    out = torch.empty((4, 128), dtype=torch.int32, device=DEV)
    code = ops._launcher()(e.data_ptr(), e.data_ptr(), None, None, None, None,
                           out.data_ptr(), out.data_ptr(), out.data_ptr(),
                           4, 64, 128, 4, 0, torch.cuda.current_stream().cuda_stream)
    check(code == 1, f"a 128-wide window on 64-entry pages launched: {code}")
    prog = (
        "import sys, torch\n"
        "sys.path.insert(0, 'src')\n"
        "from repro_torch.kernels.pte_gather import pte_gather\n"
        "i32 = dict(dtype=torch.int32, device='cuda')\n"
        "m = (torch.tensor([0, 4], **i32), torch.tensor([1, 0], **i32),\n"
        "     torch.tensor([5, 6], **i32), torch.tensor([True, True], device='cuda'))\n"
        "pte_gather(torch.full((4, 64), -1, **i32), torch.zeros(2, **i32), 0, m)\n"
        "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(run.returncode != 0 and "assert" in run.stderr.lower(),
          f"a slot outside the table was not rejected: rc {run.returncode}, "
          f"{run.stderr[-400:]}")
    said = [ln for ln in run.stderr.splitlines() if "assert" in ln.lower()]
    return {"bad_window_code": code, "bad_slot": said[0][-160:]}


def walk_staging_growth():
    """Walks whose mutation lists are longer than the manager's first staging
    buffer holds: the buffer grows, and the kernel path gives the plain
    path's frames and device table, which equals the host's."""
    def run():
        kv = PagedKVManager(n_frames=8192, block_tokens=16,
                            max_blocks_per_seq=2048, n_pods=1, device=DEV)
        first = kv._staging.buffers[0].numel()
        for sid in range(3):
            kv.start_sequence(sid, 16 * 2000, pod=0)
        n = len(kv.host._pending_mut)
        frames = [kv.physical_tables([0, 1, 2], record=False)]
        kv.finish_sequence(1)
        kv.start_sequence(3, 16 * 1500, pod=0)   # reuses sequence 1's slots
        frames.append(kv.physical_tables([0, 2, 3], record=False))
        return kv, first, n, frames

    kv, first, n, got = run()
    with plain_versions():
        plain, _, _, want = run()
    grown = max(b.numel() for b in kv._staging.buffers)
    check(13 * n > first and grown >= 13 * n,
          f"{n} mutations, first buffer {first} B, largest {grown} B")
    check(all(torch.equal(a, b) for a, b in zip(got, want))
          and torch.equal(kv.device_table, plain.device_table),
          "staged walk: kernel path and plain path differ")
    kv.check_device_table()
    return {"mutations": n, "first_buffer_bytes": first, "grown_to_bytes": grown}


def walk_wave(kv, ids, record, call, prompt_len=1024, gen_len=64):
    """One wave of the serving path's page walks, each through
    ``call(kind, fn)``: ``first`` (the wave's first walk, its 1 024
    allocations pending), ``extend`` (a decode step with extensions
    pending), ``steady`` (a decode step with none) and ``check`` (the sync of
    ``check_device_table`` after the wave's frees).  ``record`` is the
    walks' ``record`` flag."""
    for i, sid in enumerate(ids):
        kv.start_sequence(sid, prompt_len, pod=i % 4)
    call("first", lambda: kv.physical_tables(ids, record=record))
    for t in range(gen_len):
        for sid in ids:
            kv.maybe_extend(sid, prompt_len + t + 1)
        kind = "extend" if kv.host._pending_mut else "steady"
        call(kind, lambda: kv.physical_tables(ids, record=record))
    for sid in ids:
        kv.finish_sequence(sid)
    call("check", kv.sync_device_table)
    kv.check_device_table()


def walk_device_ops():
    """Device operations (kernels and copies, by name) of one walk of each
    kind, from ``torch.profiler`` around that call alone."""
    from torch.profiler import ProfilerActivity, profile
    kv = PagedKVManager(**WALK_SHAPE, device=DEV)
    ops = {}

    def call(kind, fn):
        if kind in ops:
            fn()
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops[kind] = {e.key[:80]: e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA}

    walk_wave(kv, list(range(16)), False, call)
    return ops


# ------------------------------------------------------------- kernel checks
def max_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    if not got.dtype.is_floating_point:
        return float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    return float((got.float() - want.float()).abs().max())


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
                                "kimi_k2", "whisper_decoder"],
            "flash_attention": ["gemma3_4b_local", "gemma3_4b_global",
                                "qwen3_moe", "kimi_k2", "whisper_encoder",
                                "recurrentgemma_local"]}
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
        if name == "pte_gather":
            # the list applied again leaves the table as it is: timing the
            # walk in place repeats the same work every call
            row["with_mutations"] = {
                "mutations": int(serving["wave_switch"][0][3][0].numel()),
                **timed(fn, ref, bound, library,
                        *main["pte_gather/with_mutations"])}
            row["staging_growth"] = walk_staging_growth()
            row["rejections"] = pte_rejections()
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
    return rows


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


# ------------------------------------------------------------------- serving
def release() -> None:
    """Hand the card's memory that the previous arch's weights held back to
    the allocator, so that the next arch's 35-48 GB find it in one piece."""
    gc.collect()
    torch.cuda.empty_cache()


def reset_counters() -> None:
    for fn in KERNEL_FNS.values():
        fn.launches = 0


# the prompt each arch is served with: Gemma's is longer than its 1 024-token
# window and RecurrentGemma's than its 2 048-token one, so K2's tile skip and
# the ring's wrap both run; Mamba-2's is not a multiple of its 64-token chunk,
# so its prefill state comes from the replay over the partial chunk
PROMPT_LEN = {"qwen3_14b": 1024, "gemma3_4b": 2048, "qwen3_moe_235b_a22b": 1024,
              "kimi_k2_1t_a32b": 1024, "nemotron_4_15b": 1024,
              "chameleon_34b": 1024, "yi_6b": 1024, "mamba2_370m": 2000,
              "recurrentgemma_2b": 4096}
# the depth each arch is served at (None: all its layers).  Widths are never
# cut; a depth is cut where the weights would not fit the card's 80 GB with
# the KV slabs and the activations: Qwen3-235B-A22B's 8 layers hold 38.7 GB of
# experts, Kimi-K2's 2 its dense first layer and one MoE layer (33.8 GB of
# experts), Chameleon-34B's 24 34.3 GB of weights beside 6.9 GB of slabs
SERVE_DEPTH = {"qwen3_14b": 40, "gemma3_4b": None, "qwen3_moe_235b_a22b": 8,
               "kimi_k2_1t_a32b": 2, "nemotron_4_15b": None, "chameleon_34b": 24,
               "yi_6b": None, "mamba2_370m": None, "recurrentgemma_2b": None}
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


def expected_launches(cfg, waves: int, gen_len: int, warm_up: bool) -> dict:
    """The kernel launches ``waves`` waves of the path make, from the
    config's layer groups: K1 once a decode step in each global attention
    layer (a local layer decodes from its ring, a recurrent one from its
    state), K2 once a prefill in each attention layer, K3 once a walk (a
    wave's first walk, one a decode step, and the sync of
    ``check_device_table`` after the frees).  ``warm_up``: serve()'s warm-up
    prefill and decode step add one launch a layer each."""
    n_global, n_attn = attention_layers(cfg)
    extra = 1 if warm_up else 0
    return {"paged_attention": n_global * (gen_len * waves + extra),
            "flash_attention": n_attn * (waves + extra),
            "pte_gather": (2 + gen_len) * waves}


def phase_serve(arch: str, n_layers=None, batch=16, gen_len=64, n_requests=32):
    """``serve()`` at published widths (depth cut to ``n_layers`` if given)
    with the launch counters zeroed before and read after."""
    prompt_len = PROMPT_LEN[arch]
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    r = serve(arch, full_width=True, n_layers=n_layers, batch=batch,
              prompt_len=prompt_len, gen_len=gen_len, n_requests=n_requests,
              n_pods=4, mode="numapte", verbose=False)
    counts = {name: fn.launches for name, fn in KERNEL_FNS.items()}
    waves = -(-n_requests // batch)
    cfg = get_config(arch)
    L = r["n_layers"]
    want = expected_launches(dataclasses.replace(cfg, n_layers=L), waves,
                             gen_len, warm_up=True)
    n_global = attention_layers(dataclasses.replace(cfg, n_layers=L))[0]
    check(counts == want, f"{arch}: launch counts {counts}, the path implies {want}")
    check(r["tokens"] == n_requests * gen_len, f"tokens {r['tokens']}")
    check(r["fetches"] > 0, "no numaPTE fetch in a 4-pod run")
    check(r["logits_finite"], "non-finite logits")
    ids = r.pop("token_ids")
    check(ids.shape == (n_requests, gen_len) and ids.min() >= 0
          and ids.max() < cfg.vocab_size, "token ids out of range")
    groups = layer_groups(dataclasses.replace(cfg, n_layers=L))
    emit({"phase": "serve", "arch": arch, "widths": "published",
          "family": cfg.family, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
          "n_experts": cfg.n_experts, "experts_per_token": cfg.experts_per_token,
          "moe_d_ff": cfg.moe_d_ff, "n_shared_experts": cfg.n_shared_experts,
          "first_dense_layers": cfg.first_dense_layers,
          "ssm_state": cfg.ssm_state, "lru_width": cfg.lru_width,
          "param_count": param_count(cfg),
          "active_param_count": active_param_count(cfg), "layers_run": L,
          "layers_published": cfg.n_layers,
          "layers_by_kind": {k: sum(g.n_layers for g in groups if g.kind == k)
                             for k in dict.fromkeys(g.kind for g in groups)},
          "global_layers_run": n_global,
          "local_window": cfg.local_window, "batch": batch,
          "prompt_len": prompt_len, "gen_len": gen_len, "launches": counts,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "wall_s": time.perf_counter() - t0, **r})
    return counts, want


@torch.no_grad()
def whisper_serve(cfg, params, *, batch, enc_len, prompt_len, gen_len,
                  n_requests, n_pods=4, mode="numapte", seed=0):
    """The encoder-decoder's serving loop, the counterpart of serve() (which
    takes decoder-only configs, as the reference's does): waves of
    ``batch`` requests, each a clip of ``enc_len`` frame embeddings drawn
    from a seeded generator and a decoder prompt, through the reference's
    entry points ``prefill_encdec`` and ``decode_step`` over a
    PagedKVManager's tables (start, walk, extend, finish, the invariants and
    the device table checked after each wave).  The first decode step takes
    the prefill's greedy token.  No warm-up: the kernels are built and the
    GEMM library warm by the time this runs."""
    bt = cfg.kv_block_tokens
    max_blocks = -(-(prompt_len + gen_len) // bt) + 1
    n_frames = batch * max_blocks * 4
    kv = PagedKVManager(n_frames=n_frames, block_tokens=bt,
                        max_blocks_per_seq=max_blocks, n_pods=n_pods,
                        mode=CoherenceMode(mode), device=DEV)
    state = init_decode_state(cfg, batch, n_frames, max_blocks,
                              enc_len=enc_len, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
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
        logits, st = prefill_encdec(cfg, params, feats, prompts, state,
                                    kv.physical_tables(active))
        torch.cuda.synchronize()
        t_prefilled = time.perf_counter()
        finite &= torch.isfinite(logits[:len(wave)]).all()
        tokens = greedy_sample(logits)
        steps = []
        for t in range(gen_len):
            for sid in wave:
                kv.maybe_extend(sid, prompt_len + t + 1)
            phys = kv.physical_tables(active, record=(t % 4 == 0))
            logits, st = decode_step(cfg, params, st, tokens, phys)
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
            "logits_finite": bool(finite), "token_ids": np.concatenate(sampled)}


def phase_whisper(n_pods: int = 4):
    """Whisper-base at published widths (all 12 layers) through
    ``whisper_serve``, the launch counters zeroed before and read after."""
    arch, spec = "whisper_base", WHISPER
    cfg = get_config(arch)
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    r = whisper_serve(cfg, params, n_pods=n_pods, **spec)
    counts = {name: fn.launches for name, fn in KERNEL_FNS.items()}
    waves = -(-spec["n_requests"] // spec["batch"])
    want = expected_launches(cfg, waves, spec["gen_len"], warm_up=False)
    check(counts == want, f"{arch}: launch counts {counts}, the path implies {want}")
    check(r["fetches"] > 0, "no numaPTE fetch in a 4-pod run")
    check(r["logits_finite"], "non-finite logits")
    ids = r.pop("token_ids")
    check(ids.shape == (spec["n_requests"], spec["gen_len"]) and ids.min() >= 0
          and ids.max() < cfg.vocab_size, "token ids out of range")
    emit({"phase": "serve", "arch": arch, "widths": "published",
          "family": cfg.family, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
          "param_count": param_count(cfg), "layers_run": cfg.n_layers,
          "encoder_layers": cfg.n_encoder_layers,
          "decoder_layers": cfg.n_decoder_layers, **spec,
          "encoder_dtype": "float32", "launches": counts,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "wall_s": time.perf_counter() - t0, **r})
    del params
    release()
    return counts, want


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
def routes_recorded(into: list, follow=None):
    """Append the routes (``moe.Routes``: probabilities, expert ids [N, k])
    that each MoE call of the model picks, in call order, by wrapping the
    name ``moe_forward`` looks up, as ``plain_versions`` swaps the kernels.
    With ``follow`` (the routes another run recorded) each call takes that
    run's expert ids instead of its own, its gates renormalised from its own
    probabilities; ``into`` still gets its own picks."""
    from repro_torch.models import moe
    real = moe.route

    def recording(cfg, p, xf):
        own = real(cfg, p, xf)
        into.append(own)
        if follow is None:
            return own
        eids = follow[len(into) - 1].eids
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


# per arch: the depth, then (batch, prompt, decode steps) of the bf16 logits
# check, and the serve() runs of the mode check (a partial last wave) and of
# the float32 token check (None where the weights do not fit in float32: one
# MoE layer of Kimi-K2 is 67.6 GB).  Gemma's and RecurrentGemma's prompts
# pass their windows (1 024, 2 048).  Mamba-2 runs no attention kernel, so
# its bf16 check has nothing to hold against; instead ``forward`` holds
# prefill + one decode step against forward_lm in float32 at (batch, a
# prompt that is not a multiple of the 64-token chunk).  Whisper runs all
# 12 layers through ``whisper_serve`` (serve() refuses an encoder-decoder).
PARITY = {
    "qwen3_14b": dict(
        n_layers=2, bf16=(8, 512, 1),
        modes=dict(batch=8, prompt_len=128, gen_len=8, n_requests=20),
        f32=dict(batch=8, prompt_len=256, gen_len=8, n_requests=8)),
    "gemma3_4b": dict(
        n_layers=6, bf16=(4, 1536, 3),
        modes=dict(batch=4, prompt_len=1100, gen_len=8, n_requests=10),
        f32=dict(batch=4, prompt_len=1536, gen_len=8, n_requests=4)),
    "qwen3_moe_235b_a22b": dict(
        n_layers=2, bf16=(8, 512, 3),
        modes=dict(batch=8, prompt_len=128, gen_len=8, n_requests=20),
        f32=dict(batch=8, prompt_len=256, gen_len=8, n_requests=8)),
    "kimi_k2_1t_a32b": dict(
        n_layers=2, bf16=(8, 512, 3),
        modes=dict(batch=8, prompt_len=128, gen_len=8, n_requests=20),
        f32=None),
    "mamba2_370m": dict(
        n_layers=4, bf16=None, forward=(4, 999),
        modes=dict(batch=8, prompt_len=200, gen_len=8, n_requests=20),
        f32=None),
    "recurrentgemma_2b": dict(
        n_layers=6, bf16=(4, 2600, 3),
        modes=dict(batch=4, prompt_len=2100, gen_len=8, n_requests=10),
        f32=dict(batch=4, prompt_len=2100, gen_len=8, n_requests=4)),
    "whisper_base": dict(
        n_layers=12, bf16=(16, 4, 3),
        modes=dict(batch=8, enc_len=1500, prompt_len=4, gen_len=8, n_requests=20),
        f32=dict(batch=8, enc_len=1500, prompt_len=4, gen_len=8, n_requests=8)),
}


def serve_any(arch, cfg, params, **kw):
    """serve() for a decoder-only config, whisper_serve for an
    encoder-decoder (``enc_len`` in ``kw``)."""
    if cfg.family == "encdec":
        return whisper_serve(cfg, params, **kw)
    return serve(arch, cfg=cfg, params=params, verbose=False, **kw)


def forward_parity(cfg, batch, prompt_len):
    """float32: logits of prefill(prompt_len) + one decode step against the
    last position of forward_lm over prompt_len + 1 tokens (test_models.py's
    decode-vs-forward check, on the card)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, prompt_len + 1))).to(DEV)
    want = forward_lm(cfg32, params, tokens)[0][:, -1]
    bt = cfg.kv_block_tokens
    MB = prompt_len // bt + 2
    state = init_decode_state(cfg32, batch, batch * MB, MB, device=DEV)
    phys = torch.arange(batch * MB, dtype=torch.int32, device=DEV).reshape(batch, MB)
    _, state = prefill(cfg32, params, tokens[:, :prompt_len], state, phys)
    got, _ = decode_step(cfg32, params, state, tokens[:, prompt_len], phys)
    rel = rel_err(got, want)
    check(rel < 1e-3, f"float32 decode against forward: rel {rel}")
    return {"f32_decode_vs_forward_rel": rel, "batch": batch,
            "prompt_len": prompt_len, "chunk": cfg.ssm_chunk}


@torch.no_grad()
def phase_parity(arch: str):
    spec = PARITY[arch]
    out = {"phase": "parity", "arch": arch, "layers": spec["n_layers"]}
    # bf16, published widths: logits of the kernel path against the plain path
    cfg = dataclasses.replace(get_config(arch), n_layers=spec["n_layers"])
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    if spec["bf16"] is not None:
        bf16_parity(cfg, params, spec["bf16"], out)
    else:
        out["bf16_rel"] = "not run: no kernel on this arch's model path"
    # the three coherence modes serve the same tokens
    runs = {mode: serve_any(arch, cfg, params, n_pods=4, mode=mode,
                            **spec["modes"])
            for mode in ("local", "eager", "numapte")}
    ids = [r["token_ids"] for r in runs.values()]
    check(all(np.array_equal(ids[0], x) for x in ids[1:]),
          "token ids differ between local / eager / numapte")
    out["modes_equal_tokens"] = int(ids[0].size)
    out["fetches"] = {m: r["fetches"] for m, r in runs.items()}
    del params, runs
    release()
    if "forward" in spec:
        out.update(forward_parity(cfg, *spec["forward"]))
        release()
    if spec["f32"] is None:
        if "forward" not in spec:
            out["f32_equal_tokens"] = "not run: the float32 weights do not fit"
        emit(out)
        return
    # float32 (TF32 off): greedy token ids equal, kernel path against plain
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = init_params(cfg32, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=torch.float32)
    kw = dict(n_pods=4, mode="numapte", **spec["f32"])
    got = serve_any(arch, cfg32, params, **kw)["token_ids"]
    with plain_versions():
        want = serve_any(arch, cfg32, params, **kw)["token_ids"]
    check(np.array_equal(got, want),
          "float32 token ids: kernel path and plain path differ")
    out["f32_equal_tokens"] = int(got.size)
    del params
    release()
    emit(out)


def bf16_parity(cfg, params, shape, out: dict) -> None:
    """bf16 logits of one wave (``shape``: batch, prompt, decode steps), the
    kernel path against the plain path, into ``out``."""
    routes_got, routes_want = [], []
    with routes_recorded(routes_got):
        got = first_wave(cfg, params, *shape)
    if cfg.n_experts:
        from repro_torch.models.moe import NEAR_TIE
        # Run freely, the two paths' bf16 hidden states differ by an ulp
        # here and there, a route flips where two experts' router
        # probabilities are that close, and a flipped token's output moves
        # by far more than the logits' bound; later layers then see other
        # inputs.  The input of each step's first MoE layer depends on no
        # route (its attention reads keys and values computed before any
        # MoE layer), so its flips must be near-ties.
        routes_free = []
        with plain_versions(), routes_recorded(routes_free):
            free = first_wave(cfg, params, *shape)
        per_step = len(routes_got) // (1 + shape[2])
        first = route_agreement(routes_free[::per_step], routes_got[::per_step])
        out["free_running"] = {
            "bf16_rel": [rel_err(g, w) for g, w in zip(got, free)],
            **route_agreement(routes_free, routes_got),
            "first_moe_layer": first}
        check(first["largest_gap"] < NEAR_TIE,
              f"free-running, a first-MoE-layer route differs at no near-tie: {out}")
        del free, routes_free
    # The checked comparison of the logits: the plain path takes the kernel
    # path's expert ids; its own picks may then differ only at near-ties.
    with plain_versions(), routes_recorded(
            routes_want, follow=routes_got if cfg.n_experts else None):
        want = first_wave(cfg, params, *shape)
    rels = [rel_err(g, w) for g, w in zip(got, want)]
    out["bf16_prefill_rel"], out["bf16_decode_rel"] = rels[0], rels[1:]
    if cfg.n_experts:
        out.update(route_agreement(routes_want, routes_got))
        check(out["largest_gap"] < NEAR_TIE,
              f"a route of the plain path differs at no near-tie: {out}")
    del routes_got, routes_want
    check(max(rels) < 0.03,
          f"bf16 logits: kernel path and plain path differ: {out}")


@torch.no_grad()
def phase_coherence(n_layers: int = 4):
    """The port's serving_coherence benchmark at published widths (Qwen3-14B,
    depth cut: the counters come from the host protocol, not the depth)."""
    from repro_torch.benchmarks import serving_coherence
    rows = serving_coherence.main(full_width=True, n_layers=n_layers)
    served = rows[:3]
    check([r["mode"] for r in served] == ["local", "eager", "numapte"],
          f"rows {[r['mode'] for r in rows]}")
    check(all(r["logits_finite"] and r["tokens"] == 24 * 16
              and r["n_layers"] == n_layers for r in served),
          f"serving_coherence rows: {served}")
    check(served[2]["fetches"] > 0 and served[0]["fetches"] == 0,
          "numapte fetched nothing, or local fetched")
    check(rows[3]["eager"] > rows[3]["numapte"] > 0, f"budget row {rows[3]}")
    emit({"phase": "serving_coherence", "arch": "qwen3_14b",
          "widths": "published", "layers": n_layers, "rows": rows})


# ------------------------------------------------------------------- profile
@torch.no_grad()
def phase_profile(arch: str, n_layers=None, walks: bool = True,
                  short: int = 8, long: int = 24):
    """One wave of the full-width serve at two generation lengths under the
    profiler.  Set-up, warm-up and prefill are the same in both, so the
    difference of the device's kernel time is that of ``long - short`` decode
    steps.  The shorter run less its ``short + 1`` decode steps (the warm-up
    takes one) is two prefills of the same shapes (the warm-up's and the
    wave's), with the set-up, the wave's first walk and the frees: half of
    it is the device time of one prefill, to within those.  ``walks`` adds
    the device operations of each kind of page walk."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    kw = dict(cfg=cfg, params=params, batch=16, prompt_len=PROMPT_LEN[arch],
              n_requests=16, n_pods=4, mode="numapte", verbose=False)
    plain = serve(arch, gen_len=long, **kw)

    def device_kernels(gen_len):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve(arch, gen_len=gen_len, **kw)
            torch.cuda.synchronize()
        return {e.key: (e.device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0}

    walk_ops = walk_device_ops() if walks else {}
    for kind, names in walk_ops.items():
        check(sum(names.values()) == 2
              and sum(n for k, n in names.items() if "pte_gather" in k) == 1
              and sum(n for k, n in names.items() if "Memcpy HtoD" in k) == 1,
              f"a {kind} walk made {names}, not one kernel and one copy")
    few, many = device_kernels(short), device_kernels(long)
    check(bool(many), "the profiler recorded no device time")
    steps = long - short
    per_step = {k: ((ms - few.get(k, (0.0, 0))[0]) / steps,
                    (n - few.get(k, (0.0, 0))[1]) / steps)
                for k, (ms, n) in many.items()}
    busy_ms = sum(ms for ms, _ in per_step.values())
    per_prefill = {k: ((ms - (short + 1) * per_step.get(k, (0.0, 0))[0]) / 2,
                       (n - (short + 1) * per_step.get(k, (0.0, 0))[1]) / 2)
                   for k, (ms, n) in few.items()}
    prefill_busy_ms = sum(ms for ms, _ in per_prefill.values())
    emit({"phase": "profile", "arch": arch, "layers": cfg.n_layers,
          "batch": 16, "prompt_len": PROMPT_LEN[arch], "steps_differenced": steps,
          "prefill_ms": plain["prefill_ms"],
          "decode_step_ms": plain["decode_step_ms"],
          "decode_device_busy_ms": busy_ms,
          "decode_device_idle_share": 1 - busy_ms / plain["decode_step_ms"],
          "decode_kernel_launches_per_step": sum(n for _, n in per_step.values()),
          "walk_device_ops_per_call": walk_ops,
          "top_kernels": [{"kernel": k[:80], "ms_per_step": ms,
                           "launches_per_step": n} for k, (ms, n) in sorted(
                               per_step.items(), key=lambda kv: -kv[1][0])[:10]],
          "prefill_device_busy_ms": prefill_busy_ms,
          "prefill_device_idle_share": 1 - prefill_busy_ms / plain["prefill_ms"],
          "prefill_launches": sum(n for _, n in per_prefill.values()),
          "prefill_top_kernels": [
              {"kernel": k[:80], "ms": ms, "launches": n} for k, (ms, n) in sorted(
                  per_prefill.items(), key=lambda kv: -kv[1][0])[:10]]})


# ----------------------------------------------------------------------- main
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,serve,parity,coherence")
    ap.add_argument("--layers", type=int, default=SERVE_DEPTH["qwen3_14b"],
                    help="depth of the Qwen3-14B serve and profile (widths are "
                         "never cut; every other arch runs at SERVE_DEPTH)")
    args = ap.parse_args()
    phases = args.phases.split(",")
    depth = dict(SERVE_DEPTH, qwen3_14b=args.layers)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "device", "card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "libraries": [p.name for p in built]})

    rows = phase_kernels() if "kernels" in phases else []
    if "serve" in phases:
        runs = {arch: phase_serve(arch, n) for arch, n in depth.items()}
        runs["whisper_base"] = phase_whisper()
        # every kernel that the arch's layer groups need ran, and no other
        for arch, (by_name, want) in runs.items():
            for name, n in by_name.items():
                check((n > 0) == (want[name] > 0),
                      f"{name} ran {n} times on the {arch} path, which needs "
                      f"{want[name]}")
        counts = {arch: by_name for arch, (by_name, _) in runs.items()}
        for row in rows:
            row["launches_by_arch"] = {a: c[row["name"]] for a, c in counts.items()}
            row["launches"] = sum(row["launches_by_arch"].values())
    if "parity" in phases:
        for arch in PARITY:
            phase_parity(arch)
    if "coherence" in phases:
        phase_coherence()
    if "profile" in phases:
        for i, arch in enumerate(("qwen3_14b", "gemma3_4b",
                                  "qwen3_moe_235b_a22b", "mamba2_370m",
                                  "recurrentgemma_2b")):
            phase_profile(arch, depth[arch], walks=i == 0)
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
