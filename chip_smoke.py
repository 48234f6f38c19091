#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py                  # every phase, needs one CUDA device
    python3 chip_smoke.py --phases kernels # build + kernel checks only
    python3 chip_smoke.py --phases train   # build + the training slice only
    python3 chip_smoke.py --phases kernels,multipod   # the pod axis
    python3 chip_smoke.py --phases kernels,numa_sim   # the NUMA simulator
    python3 chip_smoke.py --phases profile # where a decode step's time goes
    python3 chip_smoke.py --phases profile_train  # ... and a train step's

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
            arguments it must refuse.
            K2's backward (flash_attention_bwd) against its plain version
            (each of dq, dk, dv within 2e-5 of the plain gradient's largest
            magnitude) at the training shapes of the attention archs (Yi-6B's
            q [8,32,1024,128], Gemma-3's head_dim 256 with its 1 024 window,
            Whisper's non-causal encoder, RecurrentGemma's G = 10, a ragged
            S), the forward's LSE against the plain one in both dtypes, a
            dropped-tile control that the bound must see, and its time at
            Yi-6B's shape beside SDPA's backward.
            K1's per-row log-sum-exp (``lse``) against the plain version's
            (within 1e-5, both dtypes, a dead row, shard-local lengths past
            either end of a shard, with and without a window, one split and
            many), timed at the sequence-parallel shard shape.  K3 in its
            three coherence roles (eager's gathered drain, numaPTE's
            sharer-filtered drain, the owners' window walk and the install
            of the fetched windows) at the serving geometry (64 tables x 512,
            4 pods), bit-exact against the plain coherence functions on the
            CPU, with its launches a role
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
            over the manager's tables.  The launch counters of the kernels
            are zeroed before each and read after, and must equal what the
            arch's layer groups imply (zero for a kernel it has no layer for,
            and for K2's backward); no serving launch writes an LSE
  parity    the same widths at a cut depth, per arch: kernel path against
            plain path (bf16 logits, float32 token ids where the weights fit
            in float32, and for the MoE configs the share of expert ids that
            agree), and the three coherence modes against each other;
            Mamba-2, whose model path runs no kernel, instead holds prefill +
            one decode step against forward_lm in float32 at a ragged prompt
  coherence the port's serving_coherence benchmark (three modes of
            Qwen3-14B at published widths, 4 layers, and the budget row)
  train     Yi-6B trained at published widths, 8 of its 32 layers (TRAIN),
            batch 8 x seq 1 024, 6 steps of lm_loss -> backward -> AdamW
            from seed 0, twice: the loss lists must be bit-equal, and K2's
            forward and backward must run once a layer a step (K1 and K3
            never); step time, tokens/s, peak memory.  Then one step at 2
            layers, kernel path against plain path (loss rel <= 1e-3, every
            gradient leaf within 2e-2 of its largest value), and the
            fault-tolerant Trainer at the smoke width (12 steps, a checkpoint
            every 4, a crash at 6) whose replay must match a clean run
  multipod  the pod axis on one card (``LoopPods(4)``), Qwen3-14B and Yi-6B at
            published widths.  A: ``serve()`` of Qwen3-14B (all 40 layers,
            batch 16, prompt 1 024, 64 tokens, 32 requests) over 4 KV pools
            without device replicas (host mode ``local``) and with them, kept
            by the ``eager`` and the ``numapte`` prologue
            (``build_serve_step``), every replica checked against the host
            after every step, and one-pool: the tokens of all four equal;
            the prologue's device ms and collective bytes a step, its K3
            launches.  B: sequence-parallel decode of one 32 768-token
            context over 4 shards (all 40 layers, 32 steps, through
            ``build_serve_step(sp=True)``) against the one-pool decode of
            the same state, a token flipping only at a near-tie and in at
            most 4 steps; K1 with the LSE at the shard
            shape and the combine, timed beside the one-launch K1.  C: Yi-6B
            (2 of 32 layers, batch 8 x 1 024 over 4 pods) trained one step
            with the int8 error-feedback pod leg; its averaged gradients
            (first and second step) against an independent int8 mean of the
            pods' own gradients within 1 ulp, a dropped pod's term caught,
            the int8 average within half a scale step of the float32 one
  numa_sim  the NUMA simulator (``repro_torch.core``, host protocol in numpy)
            with pass 1 of its batch engine on the fifo_miss kernel: fig08's
            five apps x three policies at its full settings with --scale 16
            (PAPER_8SOCKET, 40 000 accesses a thread, 4 096 pages a GB,
            degree-9 prefetch, engine "batch": 8 kernel launches a run), and
            the closed serving loop (``repro_torch.serving``, every serving
            policy on one Poisson trace), each with REPRO_FIFO_MISS_BACKEND
            set to cuda and to numpy: the results must be identical, and
            fifo_miss must launch once an engine call and no other kernel
            run.  Before that, the kernel against its plain version and the
            numpy loop, bit for bit, at the reference's 25 trials, 200
            streams over a handful of vpns (ids repeating inside the
            kernel's groups of four, capacities 0-4), at the
            largest engine call of the run (the fill vector in shared
            memory) and at a stream of 2^24 accesses over 2^20 vpns (in
            global memory); timed beside the whole cuda backend call, the
            numpy loop, its byte bound and the chain's latency floor.  The
            K3 coherence roles of the kernels phase carry their byte bound
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
            copy; then Yi-6B's train step at the train phase's shape
            (``profile_train`` alone): device-busy time, idle share, launches
            and the largest kernels of a step, K2's forward and backward

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
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (NEG_INF,  # noqa: E402
                                                     visible_mask)
from repro_torch.kernels.paged_attention import (paged_attention,  # noqa: E402
                                                 paged_attention_ref)
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.pte_gather import pte_gather, pte_gather_ref  # noqa: E402
from repro_torch.kernels.fifo_miss import (densify, fifo_miss,  # noqa: E402
                                           fifo_miss_ids, fifo_miss_ref)
from repro_torch.kernels.fifo_miss import ops as fifo_ops  # noqa: E402
from repro_torch.core import (APPS, PAPER_8SOCKET, Policy,  # noqa: E402
                              SimConfig, run_app)
from repro_torch.core import batch as sim_batch  # noqa: E402
from repro_torch.serving import (SERVING_POLICIES,  # noqa: E402
                                 nominal_capacity_rps, poisson_trace,
                                 run_closed_loop)
from repro_torch.distributed import LoopPods, compression  # noqa: E402
from repro_torch.kvcache import PagedKVManager  # noqa: E402
from repro_torch.kvcache import gather as kv_gather  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import (active_param_count,  # noqa: E402
                                decode_step, forward_lm, greedy_sample,
                                init_decode_state, init_params, layer_groups,
                                lm_loss, param_count, prefill, prefill_encdec)
from repro_torch.models.transformer import DecodeState  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.pagedpt import coherence  # noqa: E402
from repro_torch.pagedpt.blocktable import (CoherenceMode,  # noqa: E402
                                            apply_mutations)
from repro_torch.runtime import (FailureInjector, Trainer,  # noqa: E402
                                 TrainerConfig, train_step, trainable)

DEV = torch.device("cuda", 0)
# published peaks of one H100 SXM (dense): bytes/s of HBM, FLOP/s by input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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
KERNEL_FNS = {"paged_attention": paged_attention,
              "flash_attention": flash_attention,
              "flash_attention_bwd": flash_attention_bwd,
              "pte_gather": pte_gather,
              "fifo_miss": fifo_miss_ids}
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
    return visible_mask(S, causal, window, DEV)


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


# -------------------------------------------------- flash attention backward
def flash_bwd_case(B, H, K, S, hd, causal, window, dtype):
    """The backward's inputs: q, k, v as ``flash_case`` makes them, the
    kernel forward's output and LSE, and an output gradient; also the
    forward's LSE error against the plain version's."""
    (q, k, v), kw = flash_case(B, H, K, S, hd, causal, window, dtype)
    out, lse = flash_ops._forward(q, k, v, causal, window, with_lse=True)
    _, want = flash_attention_ref(q, k, v, return_lse=True, **kw)
    dout = randn((B, H, S, hd), torch.float32)
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
    return nbytes / HBM_BPS, flops / PEAK_FLOPS[q.dtype]


def flash_bwd_library(args, kw):
    """Yardstick only (the port never calls it): SDPA's backward alone, the
    forward run once beforehand; returns the call to time."""
    q, k, v, out, lse, dout = args
    leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=kw["causal"],
                                       enable_gqa=True)
    g = dout.to(o.dtype)
    return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)


def flash_bwd_drop_tile(q, k, v, out, lse, dout, *, causal, window):
    """Negative control, not part of the port: the plain backward with one
    64 x 64 tile of P (the last query rows against the first keys) dropped,
    as a kernel that skipped a live tile would compute.  It must miss the
    bound, or the bound could not see such a fault."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    G, scale = H // K, hd ** -0.5
    vis = flash_visible(S, causal, window).clone()
    vis[S - 64:, :64] = False
    qg = q.reshape(B, K, G, S, hd).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    p = torch.where(vis, torch.exp(s - lse.reshape(B, K, G, S, 1)), 0.0)
    do = dout.reshape(B, K, G, S, hd)
    d = (do * out.reshape(B, K, G, S, hd)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, do)
    ds = p * (torch.einsum("bkgqd,bktd->bkgqt", do, v.float()) - d)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qg) * scale
    return dq.reshape(B, H, S, hd), dk, dv


# Yi-6B's training shape (batch 8, seq 1 024, 32 heads on 4 kv heads)
FLASH_BWD_TRAIN = (8, 32, 4, 1024, 128, True, None)


def phase_kernels_bwd() -> dict:
    """K2's backward against its plain version at the training shapes of
    the attention archs, the forward's LSE against the plain one, the
    dropped-tile control, and the timing row at Yi-6B's training shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(row, dt) for dt in (f32, bf16) for row in [
        (2, 4, 2, 100, 16, True, None),          # ragged S, smoke head_dim
        (2, 4, 2, 100, 64, True, None), (1, 8, 2, 333, 128, True, 100),
        (1, 4, 2, 256, 64, False, None), (1, 2, 1, 70, 256, False, 33),
        (2, 8, 4, 1024, 128, True, None)]]
    cases += [
        (FLASH_BWD_TRAIN, bf16), ((2,) + FLASH_BWD_TRAIN[1:], f32),
        ((2, 8, 4, 2048, 256, True, 1024), bf16),    # Gemma-3's local layers
        ((4, 8, 8, 1500, 64, False, None), f32),     # Whisper's encoder
        ((2, 10, 1, 4096, 256, True, 2048), bf16),   # RecurrentGemma's local
    ]
    rel_by_dtype, lse_by_dtype = {}, {}
    for row, dt in cases:
        args, kw, lse_err = flash_bwd_case(*row, dt)
        rel = flash_bwd_rel(flash_attention_bwd(*args, **kw),
                            flash_attention_bwd_ref(*args, **kw))
        torch.cuda.synchronize()
        key = str(dt).replace("torch.", "")
        check(max(rel.values()) <= BWD_TOL_REL,
              f"flash_attention_bwd {row} {dt}: rel err {rel} > {BWD_TOL_REL}")
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
    t_bytes, t_ops = flash_bwd_bound(args, kw)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:81",
           "tpu_backward": "none: the reference differentiates its plain jnp "
                           "attention (src/repro/models/attention.py:81)",
           "launches": 0,
           "max_abs_err": max_err(got, want),
           "rel_err": flash_bwd_rel(got, want),
           "ms": time_ms(lambda: flash_attention_bwd(*args, **kw)),
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
           "dropped_tile_rel_err": dropped, "cases": len(cases) + 1}
    del args, got, want, again
    release()
    return row


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
# ------------------------------------------------------ K1's log-sum-exp
def paged_lse(fn):
    """``fn`` (the kernel's wrapper or the plain version) returning (out,
    lse [B,H])."""
    def run(q, ks, vs, tables, lens, *, window):
        if fn is paged_attention:
            lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
            return fn(q, ks, vs, tables, lens, window=window, lse=lse), lse
        return fn(q, ks, vs, tables, lens, window=window, return_lse=True)
    return run


def paged_lse_bound(args, kw):
    t_bytes, t_ops = paged_bound(args, kw)
    return t_bytes + args[0].shape[0] * args[0].shape[1] * 4 / HBM_BPS, t_ops


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


# ----------------------------------------------------- K3's coherence roles
def coherence_role_inputs():
    """The coherence buffers of the serving path (Qwen3-14B at batch 16,
    prompt 1 024, 4 pods and 4 KV pools, numaPTE: 64 tables of 512 entries,
    d = 3): a wave's 1 024 allocations with the scheduler pod's misses on
    the rows of pods 1-3; then a wave switch (frees and the next wave's
    allocations over the same slots).  Returns [(replicas [4, 64, 512] as
    they stand before the step, (sharers, owner, mutations..., miss))]."""
    kv = PagedKVManager(**WALK_SHAPE, n_pools=4, replicas=True, device=DEV)
    pods = LoopPods(4, DEV)
    cases = []
    for wave in range(2):
        ids = list(range(16 * wave, 16 * wave + 16))
        for i in ids:
            kv.start_sequence(i, 1024, pod=i % 16 // 4)
        kv.physical_tables(ids)
        inputs = kv.coherence_inputs()
        cases.append((kv.replicas.clone(), inputs))
        specs._coherence_prologue("numapte", pods, kv.replicas, *inputs)
        for i in ids:
            kv.maybe_extend(i, 1024 + 64)
            kv.finish_sequence(i)
        kv.sync_device_table()
    return cases


def coherence_roles() -> dict:
    """Each role through K3 on the card against the plain coherence
    functions on the CPU, same inputs, bit-exact, with its K3 launches."""
    degree = specs.PREFETCH_DEGREE          # the manager's default d
    roles = {
        "eager_sync": (lambda e, s, o, t, i, v, ok, m, pods:
                       (coherence.eager_sync(e, t, i, v, ok, pods), s), 1),
        "numapte_apply_filtered": (lambda e, s, o, t, i, v, ok, m, pods:
                                   (coherence.numapte_apply_filtered(
                                       e, s, t, i, v, ok, pods), s), 1),
        "numapte_miss_fetch": (lambda e, s, o, t, i, v, ok, m, pods:
                               coherence.numapte_miss_fetch(e, s, o, m, degree,
                                                            pods), 2),
        "numapte_prologue": (lambda e, s, o, t, i, v, ok, m, pods:
                             coherence.numapte_prologue(e, s, o, t, i, v, ok, m,
                                                        degree, pods), 2),
    }
    out = {}
    real = coherence.pte_gather
    for name, (fn, launches) in roles.items():
        for replicas, inputs in coherence_role_inputs():
            before = pte_gather.launches
            walks = []

            def recorded(*args):
                # the bound reads each launch's drain list and ids before
                # the launch updates the replicas in place
                walks.append(pte_bound(tuple(args) + (None,) * (4 - len(args)),
                                       {})[0])
                return real(*args)

            coherence.pte_gather = recorded
            try:
                got = fn(replicas.clone(), *inputs, LoopPods(4, DEV))
            finally:
                coherence.pte_gather = real
            torch.cuda.synchronize()
            n = pte_gather.launches - before
            want = fn(replicas.cpu(), *(t.cpu() for t in inputs),
                      LoopPods(4, "cpu"))
            for g, w in zip(got, want):
                check(torch.equal(g.cpu(), w), f"K3 as {name} differs from the "
                      "plain coherence function")
            check(n == launches, f"{name}: {n} K3 launches, not {launches}")
            out[name] = {"k3_launches": n, "bit_exact": True,
                         "mutations": int(inputs[2].numel()),
                         "misses": int((inputs[-1] >= 0).sum()),
                         # device time of the role (queued behind a sleep: no
                         # host gap), at the wave switch's inputs
                         "ms": time_ms(lambda: fn(replicas.clone(), *inputs,
                                                  LoopPods(4, DEV))),
                         # its K3 launches' bytes (pte_bound: each drain list
                         # read once, each slot an applied mutation names and
                         # each walked id's frame, flag and window in and out
                         # once), over HBM_BPS; the replicas' clone (2 x 512
                         # KB) that the timed call makes is beside it
                         "bound_ms": 1e3 * sum(walks), "bound_by": "bytes",
                         "clone_bound_ms": 1e3 * 2 * replicas.numel() * 4
                         / HBM_BPS}
    return out


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
        if name == "paged_attention":
            row["lse"] = phase_kernels_lse()
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
            "flash_attention_bwd": 0,
            "pte_gather": (2 + gen_len) * waves, "fifo_miss": 0}


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


def phase_serve(arch: str, n_layers=None, batch=16, gen_len=64, n_requests=32):
    """``serve()`` at published widths (depth cut to ``n_layers`` if given)
    with the launch counters zeroed before and read after."""
    prompt_len = PROMPT_LEN[arch]
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with lse_pointers_counted({}) as lse:
        r = serve(arch, full_width=True, n_layers=n_layers, batch=batch,
                  prompt_len=prompt_len, gen_len=gen_len, n_requests=n_requests,
                  n_pods=4, mode="numapte", verbose=False)
    counts = {name: fn.launches for name, fn in KERNEL_FNS.items()}
    check(lse["lse_writes"] == 0, f"{arch}: serving wrote an LSE {lse}")
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
    with lse_pointers_counted({}) as lse:
        r = whisper_serve(cfg, params, n_pods=n_pods, **spec)
    counts = {name: fn.launches for name, fn in KERNEL_FNS.items()}
    check(lse["lse_writes"] == 0, f"{arch}: serving wrote an LSE {lse}")
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


# ------------------------------------------------------------------ training
# Yi-6B (the reference trainer's default arch) at published widths, depth cut
# to 8 of 32 layers: 1.91 G parameters at the float32 param_dtype take 16 bytes
# each with their gradients and two moments (30.5 GB), their bf16 copies for
# the products 3.8 GB, the activations at batch 8 x seq 1 024 about 10.5 GB
# and the logits with their float32 log-softmax about 9 GB: about 54 GB of the
# card's 80; 16 layers would need about 89 GB.
TRAIN = dict(arch="yi_6b", n_layers=8, batch=8, seq=1024, steps=6)


def train_run(cfg, ds, steps):
    """``steps`` train steps from seed 0 through ``train_step`` (lm_loss ->
    backward -> AdamW); each step's wall time ends with ``float(loss)``,
    which waits for the device.  The launch counters are zeroed before and
    read after."""
    release()
    torch.cuda.reset_peak_memory_stats()
    params = trainable(init_params(cfg, torch.Generator(device=DEV).manual_seed(0)))
    opt = adamw_init(params)
    losses, norms, step_s = [], [], []
    reset_counters()
    with lse_pointers_counted({}) as lse:
        for step in range(steps):
            batch = {k: torch.from_numpy(v).to(DEV)
                     for k, v in ds.batch_at(step).items()}
            t0 = time.perf_counter()
            params, opt, metrics = train_step(cfg, params, opt, batch)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
            norms.append(float(metrics["grad_norm"]))
    counts = {name: fn.launches for name, fn in KERNEL_FNS.items()}
    counts["lse_writes"] = lse["lse_writes"]
    out = {"losses": losses, "grad_norms": norms, "step_s": step_s,
           "counts": counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_count": sum(p.numel() for p in tree_leaves(params))}
    del params, opt
    release()
    return out


def loss_and_grads(cfg, params, batch):
    for p in tree_leaves(params):
        p.grad = None
    total, metrics = lm_loss(cfg, params, batch)
    total.backward()
    return (float(metrics["loss"].detach()),
            [p.grad.clone() for p in tree_leaves(params)])


def train_parity(n_layers=2, batch=2, seq=512) -> dict:
    """One step's loss and gradients at published widths, 2 layers, the
    kernel path (K2 forward and backward) against the plain path (autograd
    through the plain attention), bf16 activations, float32 parameters."""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=n_layers)
    params = trainable(init_params(cfg, torch.Generator(device=DEV).manual_seed(1)))
    data = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLMDataset(
        cfg.vocab_size, seq_len=seq, global_batch=batch, seed=1).batch_at(0).items()}
    reset_counters()
    loss, grads = loss_and_grads(cfg, params, data)
    check(flash_attention.launches == flash_attention_bwd.launches == n_layers,
          "the kernel path's step did not run K2 forward and backward once a layer")
    with plain_versions():
        reset_counters()
        want_loss, want = loss_and_grads(cfg, params, data)
        check(flash_attention.launches == flash_attention_bwd.launches == 0,
              "the plain path launched K2")
    rels = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(grads, want)]
    out = {"layers": n_layers, "batch": batch, "seq": seq,
           "loss_rel": abs(loss - want_loss) / abs(want_loss),
           "grad_rel_max": max(rels), "grad_rel_median": float(np.median(rels)),
           "grad_leaves": len(rels)}
    check(out["loss_rel"] <= 1e-3 and out["grad_rel_max"] <= 2e-2,
          f"training step: kernel path and plain path differ: {out}")
    del params, grads, want
    release()
    return out


def trainer_replay() -> dict:
    """The fault-tolerant Trainer on the card at the smoke width (a
    full-width checkpoint is 23 GB a save): 12 steps, a checkpoint every 4,
    a crash at step 6; the replayed losses against a clean run."""
    cfg = get_smoke_config(TRAIN["arch"])
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=32, global_batch=4)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        runs = {}
        for name, schedule in (("clean", {}), ("crash", {6: "crash"})):
            runs[name] = Trainer(
                cfg, TrainerConfig(total_steps=12, checkpoint_every=4,
                                   checkpoint_dir=os.path.join(root, name),
                                   log_every=100), ds,
                injector=FailureInjector(schedule), device=DEV).run()
    finally:
        shutil.rmtree(root)
    clean = {h["step"]: h["loss"] for h in runs["clean"]["history"]}
    hist = runs["crash"]["history"]
    rel = max(abs(h["loss"] - clean[h["step"]]) / abs(clean[h["step"]]) for h in hist)
    out = {"arch": cfg.name, "restarts": runs["crash"]["restarts"],
           "steps_run": [h["step"] for h in hist], "replay_rel_max": rel,
           "replay_bit_equal": all(h["loss"] == clean[h["step"]] for h in hist),
           "losses": [h["loss"] for h in hist]}
    check(out["restarts"] == 1 and len(hist) == 14 and rel <= 1e-5,
          f"crash/restore replay: {out}")
    return out


def phase_train():
    """Yi-6B trains at published widths (TRAIN: depth 8 of 32) twice from
    seed 0: the two loss lists must be bit-equal, K2 forward and backward
    must run once a layer a step (writing the LSE each time) and K1 / K3
    never; then the kernel path against the plain path for one step, and the
    Trainer's crash/restore replay at the smoke width.  Returns the counts
    of the first run and what the path implies."""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN["n_layers"])
    steps, tokens = TRAIN["steps"], TRAIN["batch"] * TRAIN["seq"]
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=TRAIN["seq"],
                            global_batch=TRAIN["batch"])
    first, second = train_run(cfg, ds, steps), train_run(cfg, ds, steps)
    want = {"paged_attention": 0, "flash_attention": cfg.n_layers * steps,
            "flash_attention_bwd": cfg.n_layers * steps, "pte_gather": 0,
            "fifo_miss": 0, "lse_writes": cfg.n_layers * steps}
    for run in (first, second):
        check(run["counts"] == want,
              f"train: launch counts {run['counts']}, the path implies {want}")
        check(all(np.isfinite(run["losses"])), f"non-finite loss {run['losses']}")
    check(first["losses"] == second["losses"],
          f"two runs from seed 0 differ: {first['losses']} {second['losses']}")
    step_ms = 1e3 * float(np.median(first["step_s"]))
    emit({"phase": "train", "arch": TRAIN["arch"], "widths": "published",
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
          "layers_run": cfg.n_layers,
          "layers_published": get_config(TRAIN["arch"]).n_layers,
          "depth_cut": "8 of 32 layers: parameters, gradients and two float32 "
                       "moments at 16 bytes a parameter, activations and "
                       "logits fit 80 GB at 8 layers, not at 16",
          "param_count_run": first["param_count"],
          "param_dtype": str(cfg.param_dtype).replace("torch.", ""),
          "dtype": str(cfg.dtype).replace("torch.", ""),
          "batch": TRAIN["batch"], "seq": TRAIN["seq"], "steps": steps,
          "step_ms_median": step_ms,
          "step_ms": [1e3 * x for x in first["step_s"]],
          "step_ms_second_run": [1e3 * x for x in second["step_s"]],
          "tokens_per_s": tokens / (step_ms / 1e3),
          "peak_mem_gb": first["peak_mem_gb"],
          "loss_first": first["losses"][0], "loss_last": first["losses"][-1],
          "losses": first["losses"], "grad_norms": first["grad_norms"],
          "runs_bit_equal": True, "launches": first["counts"],
          "parity": train_parity(), "trainer_replay": trainer_replay()})
    counts = {k: v for k, v in first["counts"].items() if k in KERNEL_FNS}
    return counts, {k: v for k, v in want.items() if k in KERNEL_FNS}


# ------------------------------------------------------------------ pod axis
# A: Qwen3-14B served over 4 KV pools and 4 loop pods, as the serve phase
MULTIPOD = dict(batch=16, prompt_len=1024, gen_len=64, n_requests=32, n_pods=4)
MULTIPOD_MODES = {          # path: serve() arguments (host mode, pools, replicas)
    "multipod_none": dict(mode="local", n_pools=4),
    "multipod_eager": dict(mode="eager", n_pools=4, replicas=True,
                           check_replicas=True),
    "multipod_numapte": dict(mode="numapte", n_pools=4, replicas=True,
                             check_replicas=True),
    "multipod_one_pool": dict(mode="numapte", n_pools=1),
}
# B: one Qwen3-14B context of 32 768 tokens (its native length), 4 shards;
# a token may flip at a near-tie, in at most an eighth of the steps
SP = dict(context=32768, steps=32, shards=4, max_flips=4)
# C: Yi-6B at published widths, 2 of 32 layers, batch 8 x 1 024, 4 pods
POD_TRAIN = dict(arch="yi_6b", n_layers=2, batch=8, seq=1024, pods=4)


def counts_now() -> dict:
    return {name: fn.launches for name, fn in KERNEL_FNS.items()}


def multipod_serve(params) -> dict:
    """A: the three coherence prologues and the one-pool run; returns the
    launch counts of each path beside what it implies."""
    cfg = get_config("qwen3_14b")
    runs, rows = {}, {}
    for path, kw in MULTIPOD_MODES.items():
        release()
        reset_counters()
        r = serve("qwen3_14b", full_width=True, cfg=cfg, params=params,
                  verbose=False, **MULTIPOD, **kw)
        counts = counts_now()
        want = expected_launches(cfg, waves=2, gen_len=MULTIPOD["gen_len"],
                                 warm_up=True)
        want["pte_gather"] += r.get("prologue_k3_launches", 0)
        check(counts == want, f"{path}: launch counts {counts}, the path "
              f"implies {want}")
        check(r["logits_finite"] and r["tokens"] == 32 * 64, f"{path}: {r}")
        runs[path] = (counts, want)
        rows[path] = r
    ids = rows["multipod_one_pool"]["token_ids"]
    for path, r in rows.items():
        check(np.array_equal(r.pop("token_ids"), ids),
              f"{path}: tokens differ from the one-pool run's")
    for mode in ("eager", "numapte"):
        r = rows[f"multipod_{mode}"]
        per_call = 1 if mode == "eager" else 2
        check(r["replica_mismatches"] == 0, f"{mode}: replicas differ: {r}")
        check(r["prologue_k3_launches"] == per_call * r["prologue_calls"],
              f"{mode}: {r['prologue_k3_launches']} K3 launches for "
              f"{r['prologue_calls']} prologues")
        r["k3_launches_per_prologue"] = per_call
        r["wire_bytes_per_step_per_pod"] = r["wire_bytes_per_step"] / 4
    check(rows["multipod_numapte"]["fetches"] > 0, "numaPTE fetched nothing")
    emit({"phase": "multipod_serve", "arch": "qwen3_14b", "widths": "published",
          "layers": cfg.n_layers, **MULTIPOD, "pods": "LoopPods(4)",
          "tokens_equal_one_pool": True,
          "decode_step_ms_note": "the eager and numapte runs check every "
                                 "replica against the host after each step "
                                 "(a device sync and a copy)",
          "runs": rows})
    return runs


@torch.no_grad()
def multipod_sp(params) -> dict:
    """B: prefill one context into a one-pool state; copy each column's
    frame into the pool that sequence-parallel decode reads (harness code:
    the reference has no prefill for that layout, ROADMAP queue 3); decode
    SP over LoopPods(4), then the one-pool decode fed the same tokens."""
    cfg = get_config("qwen3_14b")
    bt, n, steps = cfg.kv_block_tokens, SP["shards"], SP["steps"]
    MB = SP["context"] // bt
    MBl = MB // n
    release()
    torch.cuda.reset_peak_memory_stats()
    kv = PagedKVManager(n_frames=MB, block_tokens=bt, max_blocks_per_seq=MB,
                        n_pods=n, device=DEV)
    kv.start_sequence(0, SP["context"])
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, SP["context"] - steps))).to(DEV, torch.int32)
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
    sp = DecodeState(sp.caches, one.seq_lens.clone())
    pods = LoopPods(n, DEV)
    fed, sp_logits = [], []

    def keep(lg):
        sp_logits.append(lg.float())
        return greedy_sample(lg)

    sp_step = specs.build_serve_step(cfg, sp=True, pods=pods, sample=keep)
    tok = greedy_sample(logits)
    for _ in range(steps):
        fed.append(tok)
        tok, sp = sp_step(params, sp, tok, local)
    torch.cuda.synchronize()
    sp_counts = counts_now()
    n_layers = cfg.n_layers
    sp_want = {"paged_attention": n_layers * n * steps,
               "flash_attention": n_layers, "flash_attention_bwd": 0,
               "pte_gather": 1, "fifo_miss": 0}
    check(sp_counts == sp_want, f"sp: launch counts {sp_counts}, the path "
          f"implies {sp_want}")
    reset_counters()
    rels, agree, flips, near_ties = [], 0, [], 0
    for t in range(steps):
        lg, one = decode_step(cfg, params, one, fed[t], phys)
        lg, sl = lg.float(), sp_logits[t]
        err = float((sl - lg).abs().max())
        rels.append(err / float(lg.abs().max()))
        top2 = lg[0].topk(2).values
        near_ties += float(top2[0] - top2[1]) <= err
        a, b = int(lg.argmax()), int(sl.argmax())
        agree += a == b
        if a != b:
            # a flip is allowed only between two logits that lie no further
            # apart than the two runs' logits differ (a near-tie)
            flips.append({"step": t, "gap": float(lg[0, a] - lg[0, b]),
                          "logit_err": err})
    torch.cuda.synchronize()
    one_counts = counts_now()
    one_want = {"paged_attention": n_layers * steps, "flash_attention": 0,
                "flash_attention_bwd": 0, "pte_gather": 0, "fifo_miss": 0}
    check(one_counts == one_want, f"sp one-pool: {one_counts} not {one_want}")
    check(max(rels) < 0.03 and len(flips) <= SP["max_flips"]
          and all(f["gap"] <= f["logit_err"] for f in flips),
          f"SP decode against the one-pool decode: rel {max(rels)}, flips "
          f"{flips} (at most {SP['max_flips']})")
    # one layer's SP attention (4 shard launches with the LSE + the combine)
    # against the one launch over the same slabs (the no-mesh form), float32
    # outputs, and both timed; then K1 with the LSE at the shard shape and
    # the combine alone
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    q = randn((1, H, hd), torch.bfloat16)
    kn, vn = (randn((1, cfg.n_kv_heads, hd), torch.bfloat16) for _ in range(2))
    pos, lens = one.seq_lens - 1, one.seq_lens
    ks, vs = sp.caches[0]["k_slabs"][0], sp.caches[0]["v_slabs"][0]
    sp_attn = lambda pods_: kv_gather.decode_attention_sp(
        q, ks, vs, kn, vn, local, pos, lens, block_tokens=bt,
        n_kv=cfg.n_kv_heads, pods=pods_)[0]
    layer_err = max_err(sp_attn(pods), sp_attn(None))
    check(layer_err <= TOL["paged_attention"], f"one layer's SP attention "
          f"is {layer_err} off the one launch over the same slabs")
    sp_ms, one_ms = time_ms(lambda: sp_attn(pods)), time_ms(lambda: sp_attn(None))
    args, kw = paged_case(*SP_SHARD, None, torch.bfloat16, lens=[8192])
    shard = timed(paged_lse(paged_attention), paged_lse(paged_attention_ref),
                  paged_lse_bound, paged_library, args, kw)
    part = torch.randn((n, 1, H, hd), device=DEV)
    part_lse = torch.randn((n, 1, H), device=DEV) + 9.0
    combine_ms = time_ms(lambda: kv_gather.sp_combine(part, part_lse, pods))
    emit({"phase": "multipod_sp", "arch": "qwen3_14b", "widths": "published",
          "layers": n_layers, "context": SP["context"], "shards": n,
          "decode_steps": steps, "kv_gb": 2 * one.caches[0]["k_slabs"].numel()
          * 2 / 1e9, "logits_rel_err_max": max(rels),
          "logits_rel_err_median": float(np.median(rels)),
          "token_agreement": agree / steps, "flips_at_near_ties": flips,
          "near_tie_steps": near_ties,
          "layer_sp_vs_one_launch_err": layer_err,
          "k1_lse_shard": shard, "combine_ms": combine_ms,
          "sp_attention_layer_ms": sp_ms, "one_launch_layer_ms": one_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches_sp": sp_counts, "launches_one_pool": one_counts})
    del one, sp, kv
    release()
    return {"sp_decode": (sp_counts, sp_want),
            "sp_one_pool_decode": (one_counts, one_want)}


def fused_term(acc, q, scale):
    """acc + scale * q rounded once to float32 (acc None: scale * q), in
    float64: the pod leg's documented sum, written independently of it."""
    t = q.double() * scale.double()
    return (t if acc is None else t + acc.double()).float()


def within_ulp(got, want) -> torch.Tensor:
    """Elementwise: |got - want| <= 1 ulp of the larger, in float32."""
    big = torch.maximum(got.abs(), want.abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    return (got - want).abs() <= ulp


def multipod_train() -> dict:
    """C: Yi-6B over 4 loop pods.  The int8 error-feedback train step runs
    once through ``build_train_step`` (the path whose launches count).
    Then, from the same start, ``pod_gradients`` — the step's gradients as
    it hands them to AdamW — for the float32 leg, the int8 leg's first step
    and its second (fed the first's error buffers); each pod's own gradient
    then gives an independent int8 mean of dequant(quant(g_i + e_i)), which
    both int8 averages must equal within 1 ulp, while the mean with the last
    pod's term dropped (a planted fault) must not; the int8 and float32
    averages differ by at most the pods' mean half scale step; the error
    buffers are g - dequant(quant(g)) exactly; AdamW on the checked average
    gives the step's parameters bit for bit."""
    cfg = dataclasses.replace(get_config(POD_TRAIN["arch"]),
                              n_layers=POD_TRAIN["n_layers"])
    n, per_pod = POD_TRAIN["pods"], POD_TRAIN["batch"] // POD_TRAIN["pods"]
    data = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLMDataset(
        cfg.vocab_size, seq_len=POD_TRAIN["seq"],
        global_batch=POD_TRAIN["batch"]).batch_at(0).items()}
    fresh = lambda: init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    pods = LoopPods(n, DEV)
    release()
    torch.cuda.reset_peak_memory_stats()
    stepped = fresh()
    reset_counters()
    with lse_pointers_counted({}) as lse:
        stepped, _, m8, _ = specs.build_train_step(
            cfg, compress_pod_grads=True, pods=pods)(
                stepped, adamw_init(stepped), data)
        torch.cuda.synchronize()
    counts = counts_now()
    want = {"paged_attention": 0, "flash_attention": cfg.n_layers * n,
            "flash_attention_bwd": cfg.n_layers * n, "pte_gather": 0,
            "fifo_miss": 0}
    check(counts == want and lse["lse_writes"] == cfg.n_layers * n,
          f"pod train step: launches {counts} lse {lse}, not {want}")
    release()

    start = fresh()
    pods.reset_counters()
    avg32, m32, _ = specs.pod_gradients(cfg, start, data, pods)
    wire32 = pods.wire_bytes
    pods.reset_counters()
    avg8, _, ef = specs.pod_gradients(cfg, start, data, pods, True)
    wire8 = pods.wire_bytes
    check(float(m8["loss"]) == float(m32["loss"]),
          f"int8 leg's loss {float(m8['loss'])} != {float(m32['loss'])}")
    # each pod's own gradient, one pod at a time: the error buffers, and the
    # independent means of the first step (e = 0), of the second (e = the
    # first's buffers) and of the first without the last pod's term
    n_leaves = len(avg8)
    acc0, acc1, dropped = [None] * n_leaves, [None] * n_leaves, None
    half_steps = [0.0] * n_leaves
    residual = 0.0
    for i in range(n):
        share = {k: v[i * per_pod:(i + 1) * per_pod] for k, v in data.items()}
        g = specs._grads(cfg, start, share)[2]
        for j in range(n_leaves):
            gj = g[j].float()
            q, sc = compression.quantize_int8(gj)
            check(torch.equal(ef[j][i], gj - compression.dequantize_int8(q, sc)),
                  f"leaf {j} pod {i}: the error buffer is not "
                  "g - dequant(quant(g))")
            residual = max(residual, float(ef[j][i].abs().max() / sc))
            half_steps[j] += float(sc) / 2
            acc0[j] = fused_term(acc0[j], q, sc)
            q, sc = compression.quantize_int8(gj + ef[j][i])
            acc1[j] = fused_term(acc1[j], q, sc)
        del g
        if i == n - 2:
            dropped = [a.clone() for a in acc0]
    first = all(bool(within_ulp(a, w / n).all()) for a, w in zip(avg8, acc0))
    fault = [float((~within_ulp(a, w / n)).float().mean())
             for a, w in zip(avg8, dropped)]
    check(first, "the int8 leg's average is not the pods' mean of "
          "dequant(quant(g)) within 1 ulp")
    check(min(fault) > 0, f"dropping a pod's term went unseen in some leaf: "
          f"{fault}")
    # |avg8 - avg32| <= sum_i |dequant(quant(g_i)) - g_i| / n <= sum_i s_i/2
    # / n, plus the two sums' float32 rounding (under 1e-3 of that)
    int8_err = [float((a - b).abs().max()) / (h / n)
                for a, b, h in zip(avg8, avg32, half_steps)]
    check(max(int8_err) <= 1 + 1e-3, f"int8 average off the float32 one by "
          f"{max(int8_err)} of the pods' mean half scale step")
    del acc0, dropped, avg32
    # AdamW on the checked average gives the step's parameters
    replay = fresh()
    replay, _, _ = adamw_update(replay, avg8, adamw_init(replay))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(replay),
                                                 tree_leaves(stepped)))
    check(same, "AdamW on the checked average differs from the train step")
    del replay, stepped, avg8
    release()
    avg8b, _, _ = specs.pod_gradients(cfg, start, data, pods, True, ef)
    second = all(bool(within_ulp(a, w / n).all()) for a, w in zip(avg8b, acc1))
    check(second, "the int8 leg's second average is not the pods' mean of "
          "dequant(quant(g + e)) within 1 ulp")
    fp32_bytes, int8_bytes = compression.compression_wire_bytes(
        [t[0] for t in ef])
    emit({"phase": "multipod_train", "arch": POD_TRAIN["arch"],
          "widths": "published", **POD_TRAIN,
          "param_count_run": sum(t.numel() for t in tree_leaves(start)),
          "loss_fp32_leg": float(m32["loss"]), "loss_int8_leg": float(m8["loss"]),
          "loss_equal": True, "avg_within_1ulp_of_independent_mean": True,
          "second_step_avg_within_1ulp": True,
          "dropped_pod_control_share_off": {"min": min(fault), "max": max(fault)},
          "int8_vs_fp32_avg_over_half_step_max": max(int8_err),
          "adamw_on_checked_avg_equals_step": True,
          "ef_is_residual": True, "ef_over_scale_max": residual,
          "wire_bytes_a_pod": {"fp32": fp32_bytes, "int8": int8_bytes},
          "wire_bytes_measured": {"fp32_leg": wire32, "int8_leg": wire8},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts})
    del start, ef, avg8b, acc1
    release()
    return {"multipod_train": (counts, want)}


def phase_multipod() -> dict:
    cfg = get_config("qwen3_14b")
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    runs = multipod_serve(params)
    runs.update(multipod_sp(params))
    del params
    runs.update(multipod_train())
    return runs


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


def phase_profile_train(warm: int = 2, profiled: int = 2):
    """Yi-6B's train step at TRAIN's shape under the profiler: device-busy
    time and launches a step, the largest kernels, and the share of K2's
    forward and backward; the step's wall time comes from the steps before,
    unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN["n_layers"])
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=TRAIN["seq"],
                            global_batch=TRAIN["batch"])
    release()
    params = trainable(init_params(cfg, torch.Generator(device=DEV).manual_seed(0)))
    opt = adamw_init(params)
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in ds.batch_at(i).items()}
               for i in range(warm + profiled)]
    wall = []
    for b in batches[:warm]:
        t0 = time.perf_counter()
        params, opt, metrics = train_step(cfg, params, opt, b)
        float(metrics["loss"])
        wall.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[warm:]:
            params, opt, metrics = train_step(cfg, params, opt, b)
            float(metrics["loss"])
        torch.cuda.synchronize()
    by_kernel = {e.key: (e.device_time_total / 1e3 / profiled, e.count / profiled)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.device_time_total > 0}
    check(bool(by_kernel), "the profiler recorded no device time")
    busy = sum(ms for ms, _ in by_kernel.values())
    step_ms = 1e3 * wall[-1]

    def share(word):
        return sum(ms for k, (ms, _) in by_kernel.items() if word in k)

    emit({"phase": "profile_train", "arch": TRAIN["arch"], "layers": cfg.n_layers,
          "batch": TRAIN["batch"], "seq": TRAIN["seq"], "steps_profiled": profiled,
          "step_ms_unprofiled": step_ms, "device_busy_ms": busy,
          "device_idle_share": 1 - busy / step_ms,
          "launches_per_step": sum(n for _, n in by_kernel.values()),
          "k2_forward_ms": share("flash_attention_bf16_kernel"),
          "k2_backward_ms": share("flash_bwd_"),
          "gemm_ms": sum(ms for k, (ms, _) in by_kernel.items()
                         if any(w in k.lower() for w in ("gemm", "nvjet", "xmma", "cutlass"))),
          "top_kernels": [{"kernel": k[:80], "ms_per_step": ms, "launches_per_step": n}
                          for k, (ms, n) in sorted(by_kernel.items(),
                                                   key=lambda kv: -kv[1][0])[:15]]})
    del params, opt
    release()


# -------------------------------------------------------------- NUMA simulator
# fig08_apps at its full settings with --scale 16 (benchmarks/fig08_apps.py):
# the 8-socket machine, 40 000 accesses a thread, 4 096 pages a GB, every
# page touched, degree-9 prefetch, the batch engine (8 fifo_miss calls a run)
NUMA_APP = dict(accesses_per_thread=40_000, pages_per_gb=4_096, touch_stride=1)
NUMA_APPS = tuple(sorted(APPS))
NUMA_POLICIES = (Policy.LINUX, Policy.MITOSIS, Policy.NUMAPTE)
# the global-memory path: a stream of 2^24 accesses over 2^20 vpns, whose
# fill vector (4 MB) does not fit a block's shared memory
FIFO_LONG = dict(n=1 << 24, distinct=1 << 20, capacity=1088)
# the closed serving loop: one Poisson trace at 0.9 of nominal capacity
CLOSED_LOOP = dict(n_requests=256, load=0.9, seed=0)
# The fifo_miss chain's floor: a step's flag needs the fill count of the step
# before, so each step is at least one dependent integer compare and one add,
# at an assumed 4 cycles each (not measured here), at the card's maximum SM
# clock.  Any load of the fill vector comes on top.
CHAIN_CYCLES = 8


def fifo_trials():
    """The reference's 25 random streams, capacities and warm TLBs
    (tests/test_trace_differential.py)."""
    rng = np.random.default_rng(2024)
    for _ in range(25):
        cap = int(rng.integers(1, 64))
        n0 = int(rng.integers(0, cap + 1))
        init = rng.permutation(500)[:n0].astype(np.int64).tolist()
        arr = rng.integers(0, 1 + int(rng.integers(1, 120)),
                           size=int(rng.integers(0, 300))).astype(np.int64)
        yield arr, init, cap


def fifo_repeats():
    """Streams over a handful of vpns at capacities 0-4: ids repeat inside
    the kernel's groups of four, and lengths leave every remainder."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        cap = int(rng.integers(0, 5))
        init = rng.permutation(10)[:int(rng.integers(0, cap + 1))].tolist()
        arr = rng.integers(0, int(rng.integers(1, 7)),
                           size=int(rng.integers(0, 41))).astype(np.int64)
        yield arr, init, cap


def fifo_long_stream():
    rng = np.random.default_rng(1)
    n, u = FIFO_LONG["n"], FIFO_LONG["distinct"]
    arr = rng.integers(0, u, n)
    arr[:u] = rng.permutation(u)          # every one of the u vpns appears
    rng.shuffle(arr)
    init = rng.permutation(u)[:FIFO_LONG["capacity"]].tolist()
    return (1 << 20) + 7 * arr, [(1 << 20) + 7 * v for v in init], \
        FIFO_LONG["capacity"]


def fifo_check(arr, init, cap) -> dict:
    """Kernel, plain version and numpy loop on one stream, bit for bit;
    the seed fill vector stays as it was.  Returns the number of flags
    that differ and the walls of the plain version and of the numpy loop on
    this stream."""
    fill0, n0, ids = densify(np.asarray(arr, np.int64), init, cap)
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    got = fifo_miss_ids(f, n0, i, cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fifo_miss_ref(f, n0, i, cap)
    t1 = time.perf_counter()
    loop = fifo_miss(arr, init, cap, backend="numpy")
    t2 = time.perf_counter()
    err = max(int((got != want).sum()), int((got.cpu().numpy() != loop).sum()))
    check(err == 0 and got.shape == (len(arr),) and got.dtype == torch.bool,
          f"fifo_miss: {err} flags differ (n {len(arr)}, U {fill0.size}, "
          f"capacity {cap})")
    check(np.array_equal(f.cpu().numpy(), fill0), "fifo_miss wrote its seed")
    return {"max_abs_err": err, "plain_wall_ms": 1e3 * (t1 - t0),
            "numpy_wall_ms": 1e3 * (t2 - t1), "misses": int(loop.sum())}


def fifo_times(arr, init, cap, sm_mhz: float, iters: int) -> dict:
    """The kernel's device time, the whole ``"cuda"`` backend call's wall
    (np.unique and both copies included), the byte bound and the chain's
    floor at one stream."""
    fill0, n0, ids = densify(np.asarray(arr, np.int64), init, cap)
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    n, U = ids.size, fill0.size
    walls = []
    for _ in range(max(iters // 2, 1)):
        t0 = time.perf_counter()
        fifo_miss(arr, init, cap, backend="cuda")
        walls.append(time.perf_counter() - t0)
    # each input read once (ids and the seed), each flag written once
    t_bytes = (4 * n + 4 * U + n) / HBM_BPS
    return {"n": n, "distinct_ids": U, "capacity": cap, "tlb_entries": n0,
            "fill_vector": ("shared" if U <= fifo_ops._shared_ids(DEV.index)
                            else "global"),
            "ms": time_ms(lambda: fifo_miss_ids(f, n0, i, cap), iters=iters),
            "backend_wall_ms": 1e3 * float(np.median(walls)),
            "bound_ms": 1e3 * t_bytes, "bound_by": "bytes",
            "chain_floor_ms": n * CHAIN_CYCLES / (sm_mhz * 1e3),
            "bound_used": "bytes (bound_ms); chain_floor_ms beside it"}


def fifo_rejections() -> dict:
    """Arguments the kernel cannot take fail: the launch refuses a fill
    vector too large for shared memory without a scratch, and ids that are
    not 16-byte aligned, with cudaErrorInvalidValue; an id outside the fill
    vector fails the device assert before the walk (in a process of its
    own: the error ends its CUDA context)."""
    f = torch.zeros(60_000, dtype=torch.int32, device=DEV)
    ids = torch.zeros(8, dtype=torch.int32, device=DEV)
    mask = torch.empty(8, dtype=torch.uint8, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    launch = fifo_ops._launcher()
    too_big = launch(f.data_ptr(), 60_000, 0, ids.data_ptr(), 4, 1, None,
                     mask.data_ptr(), stream)
    misaligned = launch(f.data_ptr(), 16, 0, ids.data_ptr() + 4, 4, 1, None,
                        mask.data_ptr(), stream)
    check(too_big == 1 and misaligned == 1, f"fifo_miss launched on what it "
          f"cannot take: codes {too_big}, {misaligned}")
    prog = (
        "import sys, torch\n"
        "sys.path.insert(0, 'src')\n"
        "from repro_torch.kernels.fifo_miss import fifo_miss_ids\n"
        "i32 = dict(dtype=torch.int32, device='cuda')\n"
        "fifo_miss_ids(torch.zeros(4, **i32), 0, torch.tensor([0, 4], **i32), 2)\n"
        "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(run.returncode != 0 and "assert" in run.stderr.lower(),
          f"an id outside the fill vector was not rejected: rc "
          f"{run.returncode}, {run.stderr[-400:]}")
    said = [ln for ln in run.stderr.splitlines() if "assert" in ln.lower()]
    return {"too_big_code": too_big, "misaligned_code": misaligned,
            "bad_id": said[0][-160:]}


@contextlib.contextmanager
def engine_calls(into: list, keep: bool = False):
    """Record the batch engine's fifo_miss calls: their sizes, and with
    ``keep`` their inputs."""
    real = sim_batch.fifo_miss

    def recorded(arr, initial, capacity, **kw):
        initial = list(initial)
        into.append((np.array(arr), initial, capacity) if keep else len(arr))
        return real(arr, initial, capacity, **kw)

    sim_batch.fifo_miss = recorded
    try:
        yield into
    finally:
        sim_batch.fifo_miss = real


def numa_sim_apps(backend: str):
    os.environ["REPRO_FIFO_MISS_BACKEND"] = backend
    out, t0 = {}, time.perf_counter()
    for app in NUMA_APPS:
        for policy in NUMA_POLICIES:
            out[f"{app}/{policy.value}"] = run_app(
                policy, APPS[app], PAPER_8SOCKET,
                config=SimConfig(prefetch_degree=9, engine="batch"), **NUMA_APP)
    return out, time.perf_counter() - t0


def numa_sim_closed_loop(backend: str):
    os.environ["REPRO_FIFO_MISS_BACKEND"] = backend
    rate = CLOSED_LOOP["load"] * nominal_capacity_rps()
    trace = poisson_trace(CLOSED_LOOP["n_requests"], rate,
                          seed=CLOSED_LOOP["seed"])
    t0 = time.perf_counter()
    rows = {p: run_closed_loop(p, arrival_rate_rps=rate,
                               n_requests=len(trace), trace=trace)
            for p in SERVING_POLICIES}
    return rows, time.perf_counter() - t0


def phase_numa_sim():
    """The simulator's main path on the card: fig08's five apps x three
    policies through the batch engine with pass 1 on the fifo_miss kernel,
    then the closed serving loop, each against the numpy backend; and the
    kernel against its plain version and the numpy loop at the reference's
    trials, an engine call and a long stream.  Returns the kernel row, the
    counts of the main path and what the path implies."""
    t_phase = time.perf_counter()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    # (b) first on numpy, recording the engine's calls for (a)
    with engine_calls([], keep=True) as recorded:
        want_apps, numpy_s = numa_sim_apps("numpy")
    check(len(recorded) == 8 * len(want_apps),
          f"{len(recorded)} fifo_miss calls in {len(want_apps)} runs, not 8 each")
    want_loop, loop_numpy_s = numa_sim_closed_loop("numpy")
    # (a) the kernel against its plain version and the numpy loop
    trials = list(fifo_trials()) + list(fifo_repeats())
    err = max(fifo_check(*case)["max_abs_err"] for case in trials)
    engine = max(recorded, key=lambda c: np.unique(c[0]).size + len(c[1]))
    engine_walls = fifo_check(*engine)
    long = fifo_long_stream()
    long_walls = fifo_check(*long)
    err = max(err, engine_walls["max_abs_err"], long_walls["max_abs_err"])
    # the main path: every count 0 before, read after
    reset_counters()
    with engine_calls([]) as sizes:
        got_apps, cuda_s = numa_sim_apps("cuda")
        got_loop, loop_cuda_s = numa_sim_closed_loop("cuda")
    torch.cuda.synchronize()
    counts = counts_now()
    os.environ.pop("REPRO_FIFO_MISS_BACKEND")
    check(got_apps == want_apps, "run_app differs between the cuda and the "
          "numpy backends: " + ", ".join(k for k in want_apps
                                          if got_apps[k] != want_apps[k]))
    check(got_loop == want_loop, "run_closed_loop differs between backends")
    launched = sum(1 for n in sizes if n > 0)
    want = {"paged_attention": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "pte_gather": 0, "fifo_miss": launched}
    check(launched == 8 * len(got_apps) and counts == want,
          f"numa_sim: launch counts {counts}, the path implies {want}")
    engine_t = fifo_times(*engine, sm_mhz=sm_mhz, iters=10)
    long_t = fifo_times(*long, sm_mhz=sm_mhz, iters=3)
    fill0, n0, ids = densify(np.asarray(engine[0], np.int64), *engine[1:])
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    row = {"name": "fifo_miss", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/fifo_miss.cu",
           "replaces": "src/repro/kernels/fifo_miss.py:88", "launches": 0,
           "max_abs_err": err,
           "ms": engine_t["ms"],
           "plain_ms": time_ms(lambda: fifo_miss_ref(f, n0, i, engine[2]),
                               iters=3),
           "bound_ms": engine_t["bound_ms"], "bound_by": "bytes",
           "library_ms": None,
           "numpy_wall_ms": engine_walls["numpy_wall_ms"],
           "engine_call": {**engine_t, **engine_walls},
           "long_stream": {**long_t, **long_walls},
           "cases": len(trials) + 2, "tolerance": 0,
           "rejections": fifo_rejections()}
    emit({"phase": "numa_sim", "apps": list(NUMA_APPS),
          "policies": [p.value for p in NUMA_POLICIES],
          "topology": "PAPER_8SOCKET", **NUMA_APP, "prefetch_degree": 9,
          "engine": "batch", "cuts": [],
          "runs": len(got_apps), "fifo_miss_calls": len(sizes),
          "fifo_miss_launches": counts["fifo_miss"],
          "accesses_per_call_max": max(sizes),
          "apps_wall_s": {"numpy": numpy_s, "cuda": cuda_s},
          "closed_loop": {**CLOSED_LOOP, "policies": list(SERVING_POLICIES),
                          "wall_s": {"numpy": loop_numpy_s, "cuda": loop_cuda_s},
                          "p99_us": {p: r["p99_us"] for p, r in got_loop.items()}},
          "results_identical": True, "sm_clock_max_mhz": sm_mhz,
          "exec_ns": {k: r["exec_ns"] for k, r in got_apps.items()},
          "wall_s": time.perf_counter() - t_phase})
    return row, counts, want


# ----------------------------------------------------------------------- main
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="kernels,serve,parity,coherence,train,multipod,"
                            "numa_sim")
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
    runs = {}
    if "serve" in phases:
        runs = {arch: phase_serve(arch, n) for arch, n in depth.items()}
        runs["whisper_base"] = phase_whisper()
    if "parity" in phases:
        for arch in PARITY:
            phase_parity(arch)
    if "coherence" in phases:
        phase_coherence()
    if "train" in phases:
        runs["train_yi_6b"] = phase_train()
    if "multipod" in phases:
        runs.update(phase_multipod())
    if "numa_sim" in phases:
        fifo_row, *runs["numa_sim"] = phase_numa_sim()
        rows.append(fifo_row)
    # every kernel that the path's layer groups need ran, and no other
    for path, (by_name, want) in runs.items():
        for name, n in by_name.items():
            check((n > 0) == (want[name] > 0),
                  f"{name} ran {n} times on the {path} path, which needs "
                  f"{want[name]}")
    if runs:
        counts = {path: by_name for path, (by_name, _) in runs.items()}
        for row in rows:
            row["launches_by_arch"] = {a: c[row["name"]] for a, c in counts.items()}
            row["launches"] = sum(row["launches_by_arch"].values())
    if "profile" in phases:
        for i, arch in enumerate(("qwen3_14b", "gemma3_4b",
                                  "qwen3_moe_235b_a22b", "mamba2_370m",
                                  "recurrentgemma_2b")):
            phase_profile(arch, depth[arch], walks=i == 0)
    if "profile" in phases or "profile_train" in phases:
        phase_profile_train()
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
