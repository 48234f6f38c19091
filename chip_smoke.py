#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py                  # every phase, needs one CUDA device
    python3 chip_smoke.py --phases kernels # build + kernel checks only
    python3 chip_smoke.py --phases train   # build + the training slice only
    python3 chip_smoke.py --phases kernels_bwd  # build + K2's backward row only
    python3 chip_smoke.py --phases kernels_cap  # build + the soft-cap rows only
    python3 chip_smoke.py --phases kernels_mla  # build + K4's row only (MLA)
    python3 chip_smoke.py --phases kernels_mla,serve_mla  # K4's row, and its
                                           # launches in Moonlight's serve
    python3 chip_smoke.py --phases cap     # the logit soft-cap at full width
    python3 chip_smoke.py --phases kernels,multipod   # the pod axis
    python3 chip_smoke.py --phases kernels,model_axis # the in-pod model axis
    python3 chip_smoke.py --phases model_axis_options # its part F alone
    python3 chip_smoke.py --phases kernels,numa_sim   # the NUMA simulator
    python3 chip_smoke.py --phases kernels,cells      # the dry run's cells
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
            S, a head_dim of 80 below its tile's 128), bf16 up to head_dim
            128 on the tensor cores (dO, P and dS as two bf16 halves) with
            a float32 dO and with the train step's bf16-valued one (the
            kernels then skip the dO lo products),
            float32 and bf16 at head_dim 256 on the FMA kernels; two runs
            bit-equal; the forward's LSE against the plain one in both
            dtypes; a dropped-tile control and a single-bf16 P / dS control
            that the bound must see; and its time at Yi-6B's shape (both
            kinds of dO, and float32 inputs on the FMA kernels) beside the
            plain version and SDPA's backward.
            ``--phases kernels_bwd`` runs this row alone.
            K1, K2 and K2's backward with the logit soft-cap (cap 50, Gemma 2's
            published value, and 2, where the plain version without the cap
            must miss the bound) against their plain versions with it, both
            dtypes, also at the capped serve's Gemma-3-4B shapes (K1, K2
            global and windowed, bf16, where the cap of 2 must be seen too),
            the LSEs of the capped scores, timed at Qwen3-14B's
            serving and prefill shapes and Yi-6B's training shape beside the
            uncapped instance and flex_attention with a tanh score_mod
            (``--phases kernels_cap`` runs these rows alone).
            K4 (``mla_decode``, the paged decode of latent attention) against
            its plain version at Moonlight's widths (a 512-wide latent and a
            64-wide rope key, 16 heads, and 4 heads), one split and many, a
            dead row, rows shorter than a stage; timed at Moonlight's decode
            (B 64, 5 120 slots a row) and at the cell's shape (385 columns,
            rows of 4 112) beside gather + SDPA (``--phases kernels_mla``
            alone).
            K1's per-row log-sum-exp (``lse``) against the plain version's
            (within 1e-5, both dtypes, a dead row, shard-local lengths past
            either end of a shard, with and without a window, one split and
            many), timed at the sequence-parallel shard shape; and with
            ``kv_heads`` as well (a model shard's SP launch at model 2: q
            [1,20,128] on kv heads 4-7 of a pool, timed), and K1 on a
            shard's kv heads of 4 pools flattened through pool-global tables
            (Qwen3-14B at model 2 over 4 pools, timed).  K3 in its
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
            attention layers on rings), Moonlight-16B-A3B (all 27: latent
            attention decoding on K4, dropless sigmoid-routed experts;
            ``--phases serve_mla`` serves it alone), then Whisper-base (all 12 layers)
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
            every 4, a crash at 6) whose replay must match a clean run; these
            take no rematerialisation (remat=False, as the reference's
            Trainer).  The remat row: the same cut's gradients with remat
            False, "full" and "dots" in turn on the same weights, 3 rounds
            (each one AdamW step): losses and the first round's gradients
            bit-equal across the three, K2's forward and LSE writes doubled
            under remat; gradient ms, AdamW ms, peak GB; then the most layers
            whose step trains on the card with remat "full"
  cap       the logit soft-cap at published widths: Gemma-3-4B served (all 34
            layers, one wave of 16 x 2 048, 64 tokens) with cap 50 beside
            without: every K1 and K2 launch of the capped run is the capped
            instance and none of the other's; prefill / step ms, tokens/s;
            the capped first wave's prefill and first step against the plain
            path (logits within 0.03, tokens equal but at near-ties); one
            Yi-6B train step (8 of 32 layers, 8 x 1 024) with the cap against
            the plain path (loss 1e-3, every gradient leaf 2e-2)
  cells     the dry run (``repro_torch.launch.dryrun``): all 33 cells on one
            pod of 16 x 16 and on two, built on the meta device, each
            cell's per-device bytes equal to the count from the config's
            widths, its roofline line printed; then Yi-6B's decode_32k (8
            rows at 32 768 tokens, all 32 layers), prefill_32k (2 rows) and
            train_4k (2 rows, remat "full", depth cut to fit) as one device
            runs them (``launch/profile_cell.py``): step ms, peak GB within
            15 % of the analytic peak, busy ms and idle share, the largest
            kernels, beside the analytic bound; and the 66 cells again with
            Megatron sequence parallelism (``seq_parallel``), then the
            roofline table (``dryrun --table``) of train_4k and prefill_32k
            with it off and on
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
  model_axis the in-pod model axis (tensor parallelism, ``LoopPods`` on one
            card; the kernels phase holds K1 on a shard's kv heads of the
            replicated slab, K2 and its backward at the shard shapes).  A:
            ``serve()`` of Qwen3-14B (all 40 layers, published widths, the
            serve phase's traffic, one pod) at model = 1 and at model = 2
            from the same seeded weights: the first decode step's logits
            within 0.03, tokens equal but for first flips at near-ties (in
            at most MAX_FLIP_SHARE of the compared decisions), K1 and K2
            once a shard a layer, K3 as at
            model = 1; prefill / step ms, tokens/s, peak GB, the model axis's
            bytes a step.  B: Yi-6B (8 of 32 layers, batch 8 x 1 024, float32
            master weights) 4 steps at model = 2 against model = 1.  C: Yi-6B
            (2 of 32 layers) 6 steps at (data 2, model 4), a checkpoint equal
            to the gathered live shards, 4 more steps there and 4 restored
            onto (data 2, model 2): within 2e-2 and the bound from readings.
            E: Megatron sequence parallelism at model 2, the dry run's cells
            on the card: Yi-6B (8 of 32 layers, 8 x 1 024) 4 train steps and
            Qwen3-14B's prefill (8 of 40 layers, 16 x 1 024) with and without
            it: the first loss bit-equal and the rest within SP_LOSS_TOL,
            the prefill's logits and tokens equal, each step's launches as
            the path implies and its model-axis bytes equal to
            ``analysis.model_wire`` of its cell, and at 2 layers the first
            gradients equal but for the norm scales' (within
            SP_GRAD_TOL_REL).  F (slice 16.1c; ``--phases
            model_axis_options`` runs it alone): F1 part A over 4 KV pools
            on 4 pods (the model axis's bytes a step equal to
            ``analysis.model_wire``); F2 part B's 32 768-token context
            decoded SP over 4 pools at model 2 (each shard's heads, K1 with
            kv_heads and the LSE), held to model 1's SP decode (0.03) and
            to the one-pool decode (SP2_REL, at most SP["max_flips"] flips
            at near-ties); F3 data 2 x model 2 beside data 1 x model 2
            (Gemma-3-4B, RecurrentGemma-2B, Mamba-2 in float32, Whisper-base;
            part D's bounds, bit-equality read); F4 the families' train
            cells at model 2 beside model 1 (FAMILY_TRAIN: losses within
            MODEL_TRAIN_LOSS_TOL, step ms, peak GB, K2 / K2-backward
            launches; the MoE config follows model 1's expert ids)
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
            kernel's windows of 32, capacities 0-4), adversarial streams
            (one vpn 32 times, capacities 0, 1, 31, 32, 33, every length
            mod 32, windows that take 19 and 33 rounds), every engine call
            of the run through the engine's own ids (``dense``), the
            largest engine call (the fill vector in shared memory) and a
            stream of 2^24 accesses over 2^20 vpns (in global memory);
            timed beside the whole cuda backend call, the numpy loop, its
            byte bound and a one-step-at-a-time floor, with the walk's
            rounds a window.  The
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
import pathlib
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

from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
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
from repro_torch.distributed.sharding import use_rules  # noqa: E402
from repro_torch.kvcache import PagedKVManager  # noqa: E402
from repro_torch.kvcache import gather as kv_gather  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.launch import (analysis, dryrun, profile_cell,  # noqa: E402
                                specs)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import (active_param_count,  # noqa: E402
                                decode_step, forward_lm, greedy_sample,
                                init_decode_state, init_params, layer_groups,
                                lm_loss, param_count, prefill, prefill_encdec)
from repro_torch.models.transformer import gather_vocab  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.pagedpt import coherence  # noqa: E402
from repro_torch.pagedpt.blocktable import (CoherenceMode,  # noqa: E402
                                            apply_mutations)
from repro_torch.runtime import (FailureInjector, Trainer,  # noqa: E402
                                 TrainerConfig, train_step, trainable)
from repro_torch._tree import tree_leaves_with_path  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.common import SHAPES_ONLY  # noqa: E402

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


# ----------------------------------------------------------- paged attention
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
    return nbytes / HBM_BPS, flops / PEAK_FLOPS[q.dtype]


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
def flash_bwd_case(B, H, K, S, hd, causal, window, dtype, dout_bf16=False):
    """The backward's inputs: q, k, v as ``flash_case`` makes them, the
    kernel forward's output and LSE, and an output gradient, float32, or
    bf16-valued as the train step passes it (the model casts the attention
    output to bf16); also the forward's LSE error against the plain
    version's."""
    (q, k, v), kw = flash_case(B, H, K, S, hd, causal, window, dtype)
    out, lse = flash_ops._forward(q, k, v, causal, window, with_lse=True)
    _, want = flash_attention_ref(q, k, v, return_lse=True, **kw)
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


# Yi-6B's training shape (batch 8, seq 1 024, 32 heads on 4 kv heads), and
# one shard of it at model = 2 (16 heads on 2 kv heads)
FLASH_BWD_TRAIN = (8, 32, 4, 1024, 128, True, None)
FLASH_BWD_SHARD = (8, 16, 2, 1024, 128, True, None)


def phase_kernels_bwd() -> dict:
    """K2's backward against its plain version at the training shapes of
    the attention archs, with a float32 dO and with the train step's
    bf16-valued one (the tensor-core kernels' general and zero-lo branches),
    the forward's LSE against the plain one, the dropped-tile and the
    single-bf16 P / dS controls, and the timing row at Yi-6B's training
    shape."""
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


# ------------------------------------------------------- the logit soft-cap
# Gemma 2's published attn_logit_softcapping; the checks also run at a cap
# that bites at these inputs (unit normals: scaled scores of a few units), where
# the plain version without the cap must miss the bound, or the bound could
# not see a dropped cap
SOFTCAP = 50.0
SOFTCAP_TIGHT = 2.0
# the timed shapes: Qwen3-14B's serving (K1) and prefill (K2), Yi-6B's training
# (K2's backward)
CAP_PAGED = (16, 40, 8, 128, 16, 69, 4416, None)
CAP_FLASH = (16, 40, 8, 1024, 128, True, None)
# the capped serve's shapes, at both caps in bf16 (its dtype): Gemma-3-4B's K1
# (16 rows of 2 048 prompt tokens + 1, head_dim 256) and its K2, global and
# over its 1 024 window (q [16, 8, 2 048, 256])
CAP_GEMMA_PAGED = (16, 8, 4, 256, 16, 133, 4256, None)
CAP_GEMMA_LEN = 2049
CAP_GEMMA_FLASH = [(16, 8, 4, 2048, 256, True, None),
                   (16, 8, 4, 2048, 256, True, 1024)]


def capped(fn, cap):
    """``fn`` with ``softcap=cap``."""
    def run(*args, **kw):
        return fn(*args, softcap=cap, **kw)
    return run


def flex_score_mod(cap):
    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap
    return score_mod


def flex_library(kind: str, args, kw, cap):
    """Yardstick only (the port never calls it): the same capped function
    as one ``torch.nn.attention.flex_attention`` call with a tanh
    ``score_mod`` (K1: on the gathered blocks).  Returns (the call to time,
    or None, and what it is or why it is not there)."""
    t0 = time.perf_counter()
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                        flex_attention)
        flex = torch.compile(flex_attention, dynamic=False)
        mod = flex_score_mod(cap)
        if kind == "paged":
            q, ks, vs, tables, lens = args
            B, H, hd = q.shape
            _, bt, K, _ = ks.shape
            frames = tables.long().clamp_min(0)
            T = tables.shape[1] * bt
            live = lens.long()
            mask = lambda b, h, q_idx, kv_idx: kv_idx < live[b]
            bm = create_block_mask(mask, B, None, 1, T, device=DEV)

            def call():
                k = ks[frames].reshape(B, T, K, hd).transpose(1, 2)
                v = vs[frames].reshape(B, T, K, hd).transpose(1, 2)
                return flex(q[:, :, None], k, v, score_mod=mod, block_mask=bm,
                            enable_gqa=True)
        else:
            q, k, v = (a.detach().contiguous() for a in args[:3])
            S = q.shape[2]
            causal = lambda b, h, q_idx, kv_idx: q_idx >= kv_idx
            bm = create_block_mask(causal, None, None, S, S, device=DEV)
            if kind == "flash":
                def call():
                    return flex(q, k, v, score_mod=mod, block_mask=bm,
                                enable_gqa=True)
            else:
                leaves = [t.requires_grad_() for t in (q, k, v)]
                o = flex(*leaves, score_mod=mod, block_mask=bm, enable_gqa=True)
                g = args[5].to(o.dtype)

                def call():
                    return torch.autograd.grad(o, leaves, g, retain_graph=True)
        call()
        torch.cuda.synchronize()
        return call, {"library": "flex_attention, tanh score_mod, compiled",
                      "library_compile_s": time.perf_counter() - t0}
    except Exception as e:  # noqa: BLE001 - the yardstick is optional
        return None, {"library": f"none: flex_attention did not run here "
                                 f"({type(e).__name__}: {str(e)[:200]})"}


def cap_cases(cases, ref, fn, tol, name):
    """Each case at both caps, the kernel against its plain version; returns
    the largest error by dtype."""
    errs = {}
    for args, kw in cases:
        for cap in (SOFTCAP, SOFTCAP_TIGHT):
            got, want = capped(fn, cap)(*args, **kw), capped(ref, cap)(*args, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            dt = str(args[0].dtype).replace("torch.", "")
            check(err <= tol, f"{name} cap {cap} {tuple(args[0].shape)} {dt}: "
                              f"|err| {err} > {tol}")
            errs[dt] = max(errs.get(dt, 0.0), err)
    return errs


def no_cap_miss(ref, tol, args, kw):
    """How far the plain version without the cap lies from it with cap
    SOFTCAP_TIGHT on a case: must be past the bound, or the case could not
    see a dropped cap."""
    miss = max_err(ref(*args, **kw), capped(ref, SOFTCAP_TIGHT)(*args, **kw))
    check(miss > tol, f"{ref.__name__} {tuple(args[0].shape)}: a dropped "
                      f"cap misses by only {miss}")
    return miss


def cap_row(name, source, replaces, fn, ref, bound, library_kind, args, kw,
            errs, cases, tol, control):
    """A capped kernel's row: its check, its time beside the uncapped
    instance's at the same shape in the same call, the plain version's, the
    bound (the products; the cap's one tanh a visible pair is not counted)
    and flex_attention's."""
    t_bytes, t_ops = bound(args, kw)
    lib, lib_note = flex_library(library_kind, args, kw, SOFTCAP)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "softcap": SOFTCAP, "launches": 0,
           "max_abs_err": max_err(capped(fn, SOFTCAP)(*args, **kw),
                                  capped(ref, SOFTCAP)(*args, **kw)),
           "ms": time_ms(lambda: capped(fn, SOFTCAP)(*args, **kw)),
           "uncapped_ms": time_ms(lambda: fn(*args, **kw)),
           "plain_ms": time_ms(lambda: capped(ref, SOFTCAP)(*args, **kw)),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None if lib is None else time_ms(lib), **lib_note,
           "timed_shape": [list(a.shape) for a in args if torch.is_tensor(a)],
           "max_abs_err_by_dtype": errs, "tolerance": tol, "cases": cases,
           "caps_checked": [SOFTCAP, SOFTCAP_TIGHT],
           "no_cap_control_err": control}
    check(control > tol, f"{name}: the plain version without the cap misses "
                         f"by {control}, within {tol}: the bound cannot see it")
    return row


def flash_bwd_cap_case(B, H, K, S, hd, causal, window, dtype, cap,
                       dout_bf16=False):
    """``flash_bwd_case`` with the kernel forward's output and LSE capped."""
    (q, k, v), kw = flash_case(B, H, K, S, hd, causal, window, dtype)
    out, lse = flash_ops._forward(q, k, v, causal, window, with_lse=True,
                                  softcap=cap)
    _, want = flash_attention_ref(q, k, v, return_lse=True, softcap=cap, **kw)
    dout = randn((B, H, S, hd), torch.float32)
    if dout_bf16:
        dout = dout.to(torch.bfloat16).float()
    return (q, k, v, out, lse, dout), kw, max_err(lse, want)


def phase_kernels_cap() -> list:
    """K1, K2 and K2's backward with the logit soft-cap against their plain
    versions with it (both dtypes, both caps, the reference's bounds), the
    LSEs of the capped scores, a control that the bounds see a dropped cap,
    and the three timed rows."""
    f32, bf16 = torch.float32, torch.bfloat16
    both = (f32, bf16)
    rows = []
    # K1
    paged = [paged_case(*row, dt) for dt in both for row in [
        (2, 8, 2, 64, 16, 8, 32, None), (2, 16, 2, 64, 8, 16, 48, 24),
        (1, 4, 1, 32, 4, 4, 8, None), (2, 32, 2, 64, 16, 8, 32, None),
        (2, 8, 2, 256, 16, 8, 32, None)]]
    paged += [paged_case(4, 8, 2, 64, 16, 8, 32, None, dt, dead_row=True)
              for dt in both]
    paged += [paged_case(16, 20, 8, 128, 16, 69, 4416, None, dt,
                         kv_heads=(4, 4)) for dt in both]
    paged += [paged_case(*CAP_PAGED, dt, lens=np.full(16, 1057)) for dt in both]
    gemma = paged_case(*CAP_GEMMA_PAGED, bf16, lens=np.full(16, CAP_GEMMA_LEN))
    paged.append(gemma)
    errs = cap_cases(paged, paged_attention_ref, paged_attention,
                     TOL["paged_attention"], "paged_attention")
    gemma_control = [no_cap_miss(paged_attention_ref, TOL["paged_attention"],
                                 *gemma)]
    del gemma
    lse_err = 0.0
    for args, kw in lse_cases()[:4]:
        lse = torch.empty(args[0].shape[:2], dtype=torch.float32, device=DEV)
        paged_attention(*args, lse=lse, softcap=SOFTCAP_TIGHT, **kw)
        _, want = paged_attention_ref(*args, return_lse=True,
                                      softcap=SOFTCAP_TIGHT, **kw)
        lse_err = max(lse_err, max_err(lse, want))
    check(lse_err <= LSE_TOL, f"K1's capped lse: |err| {lse_err}")
    args, kw = paged_case(*CAP_PAGED, bf16, lens=np.full(16, 1057))
    control = max_err(paged_attention_ref(*args, **kw),
                      capped(paged_attention_ref, SOFTCAP_TIGHT)(*args, **kw))
    row = cap_row("paged_attention/softcap",
                  "src/repro_torch/kernels/csrc/paged_attention.cu",
                  "src/repro/kernels/paged_attention/kernel.py:91",
                  paged_attention, paged_attention_ref, paged_bound, "paged",
                  args, kw, errs, 2 * len(paged), TOL["paged_attention"], control)
    row.update(lse_max_abs_err=lse_err, gemma3_4b_shape=list(CAP_GEMMA_PAGED),
               gemma3_4b_no_cap_control_err=gemma_control)
    rows.append(row)
    del paged, args
    # K2 forward
    flash = [flash_case(*row, dt) for dt in both for row in [
        (2, 4, 2, 128, 64, True, None), (2, 4, 1, 128, 128, True, 64),
        (1, 4, 2, 256, 64, False, None), (2, 4, 2, 100, 16, True, None),
        (1, 2, 1, 70, 256, False, 33), (2, 40, 8, 1024, 128, True, None)]]
    gemma = [flash_case(*row, bf16) for row in CAP_GEMMA_FLASH]
    errs = cap_cases(flash + gemma, flash_attention_ref, flash_attention,
                     TOL["flash_attention"], "flash_attention")
    gemma_control = [no_cap_miss(flash_attention_ref, TOL["flash_attention"],
                                 *case) for case in gemma]
    del gemma
    lse_err = 0.0
    for (q, k, v), kw in flash[:6]:
        _, lse = flash_ops._forward(q, k, v, kw["causal"], kw["window"],
                                    with_lse=True, softcap=SOFTCAP_TIGHT)
        _, want = flash_attention_ref(q, k, v, return_lse=True,
                                      softcap=SOFTCAP_TIGHT, **kw)
        lse_err = max(lse_err, max_err(lse, want))
    check(lse_err <= TOL["flash_attention"], f"K2's capped lse: |err| {lse_err}")
    args, kw = flash_case(*CAP_FLASH, bf16)
    control = max_err(flash_attention_ref(*args, **kw),
                      capped(flash_attention_ref, SOFTCAP_TIGHT)(*args, **kw))
    row = cap_row("flash_attention/softcap",
                  "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention/kernel.py:81",
                  flash_attention, flash_attention_ref, flash_bound, "flash",
                  args, kw, errs, 2 * (len(flash) + len(CAP_GEMMA_FLASH)),
                  TOL["flash_attention"], control)
    row.update(lse_max_abs_err=lse_err, gemma3_4b_shapes=CAP_GEMMA_FLASH,
               gemma3_4b_no_cap_control_err=gemma_control)
    rows.append(row)
    del flash, args
    # K2's backward: each case at both caps, both kinds of dO
    rel_by = {}
    shapes = [((2, 4, 2, 100, 16, True, None), f32),
              ((2, 4, 2, 100, 16, True, None), bf16),
              ((1, 8, 2, 333, 128, True, 100), bf16),
              ((1, 4, 2, 256, 64, False, None), bf16),
              ((1, 2, 1, 70, 256, False, 33), bf16),     # head_dim 256: FMAs
              ((2,) + FLASH_BWD_TRAIN[1:], f32), (FLASH_BWD_TRAIN, bf16)]
    n = 0
    for shape, dt in shapes:
        for cap in (SOFTCAP, SOFTCAP_TIGHT):
            for dout_bf16 in ((False, True) if dt == bf16 else (False,)):
                a, kw, lse_err = flash_bwd_cap_case(*shape, dt, cap,
                                                    dout_bf16=dout_bf16)
                rel = flash_bwd_rel(flash_attention_bwd(*a, softcap=cap, **kw),
                                    flash_attention_bwd_ref(*a, softcap=cap,
                                                            **kw))
                torch.cuda.synchronize()
                check(max(rel.values()) <= BWD_TOL_REL and
                      lse_err <= TOL["flash_attention"],
                      f"flash_attention_bwd cap {cap} {shape} {dt}: {rel}, "
                      f"lse {lse_err}")
                key = str(dt).replace("torch.", "") + (
                    "/bf16_valued_dout" if dout_bf16 else "")
                rel_by[key] = max(rel_by.get(key, 0.0), *rel.values())
                n += 1
                del a
    args, kw, _ = flash_bwd_cap_case(*FLASH_BWD_TRAIN, bf16, SOFTCAP,
                                     dout_bf16=True)
    want = capped(flash_attention_bwd_ref, SOFTCAP_TIGHT)(*args, **kw)
    control = min(flash_bwd_rel(flash_attention_bwd_ref(*args, **kw),
                                want).values())
    row = cap_row("flash_attention_bwd/softcap",
                  "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention/kernel.py:81",
                  flash_attention_bwd, flash_attention_bwd_ref,
                  flash_bwd_bound, "flash_bwd", args, kw, rel_by, n,
                  BWD_TOL_REL, control)
    row.update(tolerance_rel=BWD_TOL_REL,
               dout="bf16-valued (the train step's)",
               rel_err=flash_bwd_rel(
                   capped(flash_attention_bwd, SOFTCAP)(*args, **kw),
                   capped(flash_attention_bwd_ref, SOFTCAP)(*args, **kw)))
    rows.append(row)
    del args, want
    release()
    return rows


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
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(tracing.PREFIX)}

    walk_wave(kv, list(range(16)), False, call)
    return ops


# ------------------------------------------------------------- kernel checks
# ------------------------------------------------------ K1's log-sum-exp
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
POOLS = 4


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


# ------------------------------------------------- latent attention (K4)
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
    return nbytes / HBM_BPS, 2 * H * (dk + dv) * n_live / PEAK_FLOPS[q.dtype]


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
    """K4 (paged MLA decode) against its plain version at Moonlight's
    widths: one split and many, a dead row, ragged lengths, fewer heads than 16,
    rows shorter than a stage, a row ending inside one beside a dead row;
    the combine's counters back at 0; timed at Moonlight's decode (B 64,
    16 heads, 5 120 slots a row) and at the cell's shape (385 columns, rows of
    4 112: the table's last quarter dead) beside the plain version and gather +
    SDPA, each with its split count; the bf16-P control that the bound must
    see."""
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


# the prompt each arch is served with: Gemma's is longer than its 1 024-token
# window and RecurrentGemma's than its 2 048-token one, so K2's tile skip and
# the ring's wrap both run; Mamba-2's is not a multiple of its 64-token chunk,
# so its prefill state comes from the replay over the partial chunk
PROMPT_LEN = {"qwen3_14b": 1024, "gemma3_4b": 2048, "qwen3_moe_235b_a22b": 1024,
              "kimi_k2_1t_a32b": 1024, "nemotron_4_15b": 1024,
              "chameleon_34b": 1024, "yi_6b": 1024, "mamba2_370m": 2000,
              "recurrentgemma_2b": 4096, "moonlight_16b_a3b": 1024}
# the depth each arch is served at (None: all its layers).  Widths are never
# cut; a depth is cut where the weights would not fit the card's 80 GB with
# the KV slabs and the activations: Qwen3-235B-A22B's 8 layers hold 38.7 GB of
# experts, Kimi-K2's 2 its dense first layer and one MoE layer (33.8 GB of
# experts), Chameleon-34B's 24 34.3 GB of weights beside 6.9 GB of slabs.
# Moonlight-16B-A3B (latent attention on K4, dropless sigmoid-routed
# experts) runs whole: 31.9 GB
SERVE_DEPTH = {"qwen3_14b": 40, "gemma3_4b": None, "qwen3_moe_235b_a22b": 8,
               "kimi_k2_1t_a32b": 2, "nemotron_4_15b": None, "chameleon_34b": 24,
               "yi_6b": None, "mamba2_370m": None, "recurrentgemma_2b": None,
               "moonlight_16b_a3b": None}
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
    counts = counts_now()
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
          "kv_lora_rank": cfg.kv_lora_rank,
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
    counts = counts_now()
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
    counts = counts_now()
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
    total, metrics = lm_loss(cfg, params, batch, remat=False)
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


# the remat row: TRAIN's cut, the gradients of one set of weights taken with
# each policy in turn (the order rotated every round), then one AdamW step
REMAT = dict(modes=(False, "full", "dots"), rounds=3)


def k2_launches(cfg, remat) -> dict:
    """K2's launches in one gradient of ``cfg`` (one attention layer a
    layer): the recomputation of ``"full"`` and ``"dots"`` runs each
    layer's forward, and writes its LSE, a second time."""
    fwd = cfg.n_layers * (2 if remat else 1)
    return uncapped({"paged_attention": 0, "flash_attention": fwd,
                     "flash_attention_bwd": cfg.n_layers, "pte_gather": 0,
                     "fifo_miss": 0, "lse_writes": fwd})


def remat_row(cfg, ds) -> dict:
    """The gradients of Yi-6B (TRAIN's cut) with ``remat`` False, "full"
    and "dots", taken in turn on the same weights, ``REMAT["rounds"]``
    rounds (each a batch and one AdamW step on the last policy's
    gradients): the losses must be bit-equal across the policies in every
    round and the first round's gradients bit for bit; K2's launches must
    follow the path (``k2_launches``).  Each policy's gradient ms (CUDA
    events) and its peak GB beside the rest of the step (AdamW's ms and
    peak) from the rounds after the first (the first holds one policy's
    gradients for the comparison)."""
    modes, rounds = REMAT["modes"], REMAT["rounds"]
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
    opt = adamw_init(params)
    grad_ms = {m: [] for m in modes}
    peaks = {m: [] for m in modes}
    losses = {m: [] for m in modes}
    adam_ms, adam_peak, counts = [], [], {}
    for r in range(rounds):
        batch = {k: torch.from_numpy(v).to(DEV)
                 for k, v in ds.batch_at(r).items()}
        order = modes[r % len(modes):] + modes[:r % len(modes)]
        first = grads = None
        for m in order:
            grads = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            with lse_pointers_counted({}) as lse:
                start.record()
                _, metrics, grads = specs._grads(cfg, params, batch, remat=m)
                end.record()
                torch.cuda.synchronize()
            got = dict(counts_now(), lse_writes=lse["lse_writes"])
            check(got == k2_launches(cfg, m),
                  f"remat {m}: launches {got}, the path implies "
                  f"{k2_launches(cfg, m)}")
            counts[m] = got
            losses[m].append(float(metrics["loss"].detach()))
            grad_ms[m].append(start.elapsed_time(end))
            peaks[m].append(torch.cuda.max_memory_allocated() / 1e9)
            if r == 0 and first is None:
                first = grads
            elif r == 0:
                check(all(torch.equal(a, b) for a, b in zip(grads, first)),
                      f"remat {m}: the first round's gradients differ from "
                      f"remat {order[0]}'s")
        del first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        params, opt, _ = adamw_update(params, grads, opt)
        end.record()
        torch.cuda.synchronize()
        adam_ms.append(start.elapsed_time(end))
        adam_peak.append(torch.cuda.max_memory_allocated() / 1e9)
        del grads
    check(all(losses[m] == losses[modes[0]] for m in modes),
          f"remat: losses differ across the policies: {losses}")
    del params, opt
    release()
    tokens = TRAIN["batch"] * TRAIN["seq"]
    adam = float(np.median(adam_ms[1:]))
    out = {"modes": {}, "losses": losses[modes[0]], "rounds": rounds,
           "losses_bit_equal": True, "first_round_grads_bit_equal": True,
           "adamw_ms": adam, "adamw_peak_gb": max(adam_peak[1:])}
    for m in modes:
        g = float(np.median(grad_ms[m][1:]))
        out["modes"][str(m)] = {
            "grad_ms": g, "grad_ms_all": grad_ms[m], "step_ms": g + adam,
            "tokens_per_s": tokens / ((g + adam) / 1e3),
            "grad_peak_gb": max(peaks[m][1:]),
            "peak_gb": max(max(peaks[m][1:]), max(adam_peak[1:])),
            "launches": counts[m]}
    base = out["modes"]["False"]["step_ms"]
    for m in modes:
        out["modes"][str(m)]["step_vs_no_remat"] = out["modes"][str(m)]["step_ms"] / base
    return out


def train_fits(n_layers: int, steps: int = 2):
    """TRAIN's shape at ``n_layers`` with remat "full" through
    ``build_train_step``: (step ms of the last step, peak GB), or None when
    the card runs out of memory."""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=n_layers)
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=TRAIN["seq"],
                            global_batch=TRAIN["batch"])
    release()
    torch.cuda.reset_peak_memory_stats()
    try:
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0))
        opt = adamw_init(params)
        step = specs.build_train_step(cfg, remat="full")
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(DEV)
                     for k, v in ds.batch_at(i).items()}
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            float(m["loss"])
            dt = time.perf_counter() - t0
        out = (1e3 * dt, torch.cuda.max_memory_allocated() / 1e9)
    except torch.cuda.OutOfMemoryError:
        out = None
    params = opt = None
    release()
    return out


def largest_cut() -> dict:
    """The most of Yi-6B's 32 layers whose train step at TRAIN's batch runs
    on the card with remat "full": from the analytic prediction (the most
    layers whose ``analysis.peak_bytes`` fits the card's memory), one layer
    more until a step runs out of memory, or fewer until one fits."""
    total = torch.cuda.get_device_properties(DEV).total_memory
    shape = tconfigs.ShapeSpec("train_1k", TRAIN["seq"], TRAIN["batch"], "train")
    full = get_config(TRAIN["arch"]).n_layers
    opts = specs.PerfOptions(remat="full")
    predicted = profile_cell.fit_layers(TRAIN["arch"], shape, TRAIN["batch"],
                                        opts, budget=total)

    def analytic(L):
        return analysis.peak_bytes(profile_cell._cell(
            TRAIN["arch"], shape, TRAIN["batch"], L, opts, "meta")) / 1e9

    tried, L = {}, max(predicted, 1)
    while True:
        tried[L] = train_fits(L)
        if tried[L] is not None and L < full and L + 1 not in tried:
            L += 1
        elif tried[L] is None and L > 1 and L - 1 not in tried:
            L -= 1
        else:
            break
    fit = max([k for k, v in tried.items() if v is not None], default=0)
    check(fit > TRAIN["n_layers"], f"remat full fits {fit} layers, no more "
                                   f"than the {TRAIN['n_layers']} without it")
    return {"predicted_layers": predicted, "analytic_peak_gb": analytic(fit),
            "card_total_gb": total / 1e9, "largest_layers": fit,
            "step_ms": tried[fit][0], "peak_gb": tried[fit][1],
            "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / (tried[fit][0] / 1e3),
            "tried": {str(k): v for k, v in sorted(tried.items())}}


def phase_train():
    """Yi-6B trains at published widths (TRAIN: depth 8 of 32) twice from
    seed 0 without rematerialisation: the two loss lists must be bit-equal,
    K2 forward and backward must run once a layer a step (writing the LSE
    each time) and K1 / K3 never; then the remat row (``remat_row``: the
    three policies' losses and gradients bit-equal, K2's forward and LSE
    writes doubled under remat) and the largest layer cut that trains with
    remat "full" (``largest_cut``); then the kernel path against the plain
    path for one step, and the Trainer's crash/restore replay at the smoke
    width.  Returns the counts of the first run and the remat row's, with
    what the path implies."""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN["n_layers"])
    steps, tokens = TRAIN["steps"], TRAIN["batch"] * TRAIN["seq"]
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=TRAIN["seq"],
                            global_batch=TRAIN["batch"])
    first, second = train_run(cfg, ds, steps), train_run(cfg, ds, steps)
    want = uncapped({"paged_attention": 0, "flash_attention": cfg.n_layers * steps,
                     "flash_attention_bwd": cfg.n_layers * steps, "pte_gather": 0,
                     "fifo_miss": 0, "lse_writes": cfg.n_layers * steps})
    for run in (first, second):
        check(run["counts"] == want,
              f"train: launch counts {run['counts']}, the path implies {want}")
        check(all(np.isfinite(run["losses"])), f"non-finite loss {run['losses']}")
    check(first["losses"] == second["losses"],
          f"two runs from seed 0 differ: {first['losses']} {second['losses']}")
    step_ms = 1e3 * float(np.median(first["step_s"]))
    remat = remat_row(cfg, ds)
    emit({"phase": "train_remat", "arch": TRAIN["arch"],
          "layers": cfg.n_layers, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
          **remat, "largest_cut_full": largest_cut()})
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
          "remat": False, "runs_bit_equal": True, "launches": first["counts"],
          "parity": train_parity(), "trainer_replay": trainer_replay()})
    kernels = lambda c: {k: v for k, v in c.items() if k in COUNTED}
    modes = REMAT["modes"]
    rounds = REMAT["rounds"]
    remat_counts = {k: rounds * sum(remat["modes"][str(m)]["launches"][k]
                                    for m in modes) for k in COUNTED}
    remat_want = {k: rounds * sum(k2_launches(cfg, m)[k] for m in modes)
                  for k in COUNTED}
    return {"train_yi_6b": (kernels(first["counts"]), kernels(want)),
            "train_remat_yi_6b": (remat_counts, remat_want)}


# ------------------------------------------------------------- the soft-cap
# Gemma-3-4B served with the cap at published widths, all 34 layers, one wave
# (batch 16, prompt 2 048 past its 1 024 window); Yi-6B's train step (TRAIN's
# cut) with the cap
CAP_SERVE = dict(arch="gemma3_4b", batch=16, prompt_len=2048, gen_len=64,
                 n_requests=16)


def cap_serve() -> dict:
    """``serve()`` of Gemma-3-4B with ``attn_logit_softcap`` = SOFTCAP beside
    the same run without it: every K1 and K2 launch of the capped run is the
    capped instance, none of the other's; then the capped first wave's
    prefill and first decode step, the kernel path against the plain one."""
    arch = CAP_SERVE["arch"]
    cfg0 = get_config(arch)
    runs, out = {}, {}
    for tag, cfg in (("uncapped", cfg0),
                     ("capped", dataclasses.replace(cfg0,
                                                    attn_logit_softcap=SOFTCAP))):
        release()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        r = serve(arch, cfg=cfg, full_width=True, n_pods=4, mode="numapte",
                  verbose=False, **{k: v for k, v in CAP_SERVE.items()
                                    if k != "arch"})
        counts = counts_now()
        want = expected_launches(cfg, 1, CAP_SERVE["gen_len"], warm_up=True)
        on = tag == "capped"
        want.update({"paged_attention/softcap": want["paged_attention"] * on,
                     "flash_attention/softcap": want["flash_attention"] * on,
                     "flash_attention_bwd/softcap": 0})
        check(counts == want, f"cap serve {tag}: launches {counts}, not {want}")
        check(r["logits_finite"], f"cap serve {tag}: non-finite logits")
        out[tag] = {k: r[k] for k in ("prefill_ms", "decode_step_ms",
                                      "tok_per_s")}
        out[tag]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[tag]["launches"] = counts
        runs[f"cap_serve_{tag}"] = (counts, want)
    cfg = dataclasses.replace(cfg0, attn_logit_softcap=SOFTCAP)
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    shape = (CAP_SERVE["batch"], CAP_SERVE["prompt_len"], 1)
    with torch.no_grad():
        got = first_wave(cfg, params, *shape)
        with plain_versions():
            want = first_wave(cfg, params, *shape)
    rels = [rel_err(g, w) for g, w in zip(got, want)]
    ids_g = [g.argmax(-1) for g in got]
    ids_w = [w.argmax(-1) for w in want]
    flips = []
    for g, w, ig, iw, rel in zip(got, want, ids_g, ids_w, rels):
        for r in torch.nonzero(ig != iw).flatten().tolist():
            top = w[r].topk(2).values
            flips.append({"margin": float(top[0] - top[1]),
                          "logit_err": float((g[r] - w[r]).abs().max())})
    out["parity"] = {"bf16_prefill_rel": rels[0], "bf16_decode_rel": rels[1:],
                     "tokens_compared": sum(i.numel() for i in ids_g),
                     "tokens_equal": sum(int((a == b).sum())
                                         for a, b in zip(ids_g, ids_w)),
                     "flips": flips}
    check(max(rels) < 0.03, f"cap serve: kernel path and plain path differ: "
                            f"{out['parity']}")
    check(all(f["margin"] <= 2 * f["logit_err"] for f in flips),
          f"cap serve: a token flips at no near-tie: {flips}")
    del params, got, want
    release()
    emit({"phase": "cap_serve", "arch": arch, "widths": "published",
          "layers": cfg.n_layers, "softcap": SOFTCAP, **CAP_SERVE, **out})
    return runs


def cap_train() -> dict:
    """One Yi-6B train step (TRAIN's cut) with the cap: loss and gradients
    of the kernel path (K2 and its backward, capped) against the plain
    path's, every gradient leaf held to train_parity's bounds."""
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN["n_layers"],
                              attn_logit_softcap=SOFTCAP)
    release()
    params = trainable(init_params(cfg, torch.Generator(device=DEV).manual_seed(0)))
    data = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticLMDataset(
        cfg.vocab_size, seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
        seed=1).batch_at(0).items()}
    reset_counters()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg, params, data)
    step_s = time.perf_counter() - t0
    counts = counts_now()
    L = cfg.n_layers
    want = {"paged_attention": 0, "flash_attention": L,
            "flash_attention_bwd": L, "pte_gather": 0, "fifo_miss": 0,
            "mla_decode": 0, "paged_attention/softcap": 0, "flash_attention/softcap": L,
            "flash_attention_bwd/softcap": L}
    check(counts == want, f"cap train: launches {counts}, not {want}")
    with plain_versions():
        want_loss, want_grads = loss_and_grads(cfg, params, data)
    rels = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(grads, want_grads)]
    out = {"layers": L, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
           "softcap": SOFTCAP, "loss": loss, "plain_loss": want_loss,
           "loss_rel": abs(loss - want_loss) / abs(want_loss),
           "grad_rel_max": max(rels), "grad_rel_median": float(np.median(rels)),
           "grad_leaves": len(rels), "kernel_path_s": step_s,
           "launches": counts}
    check(out["loss_rel"] <= 1e-3 and out["grad_rel_max"] <= 2e-2,
          f"cap train: kernel path and plain path differ: {out}")
    del params, grads, want_grads
    release()
    emit({"phase": "cap_train", "arch": TRAIN["arch"], "widths": "published",
          **out})
    return {"cap_train_yi_6b": (counts, want)}


def phase_cap() -> dict:
    runs = cap_serve()
    runs.update(cap_train())
    return runs


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
    sp = sp._replace(seq_lens=one.seq_lens.clone())
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
    sp_want = uncapped({"paged_attention": n_layers * n * steps,
                        "flash_attention": n_layers, "flash_attention_bwd": 0,
                        "pte_gather": 1, "fifo_miss": 0})
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
    one_want = uncapped({"paged_attention": n_layers * steps, "flash_attention": 0,
                         "flash_attention_bwd": 0, "pte_gather": 0, "fifo_miss": 0})
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
            cfg, compress_pod_grads=True, pods=pods, remat=False)(
                stepped, adamw_init(stepped), data)
        torch.cuda.synchronize()
    counts = counts_now()
    want = uncapped({"paged_attention": 0, "flash_attention": cfg.n_layers * n,
                     "flash_attention_bwd": cfg.n_layers * n, "pte_gather": 0,
                     "fifo_miss": 0})
    check(counts == want and lse["lse_writes"] == cfg.n_layers * n,
          f"pod train step: launches {counts} lse {lse}, not {want}")
    release()

    start = fresh()
    pods.reset_counters()
    avg32, m32, _ = specs.pod_gradients(cfg, start, data, pods, remat=False)
    wire32 = pods.wire_bytes
    pods.reset_counters()
    avg8, _, ef = specs.pod_gradients(cfg, start, data, pods, True,
                                      remat=False)
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
        g = specs._grads(cfg, start, share, remat=False)[2]
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
    avg8b, _, _ = specs.pod_gradients(cfg, start, data, pods, True, ef,
                                      remat=False)
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


# ---------------------------------------------------------------- model axis
# A: Qwen3-14B (all 40 layers) served at model = 2 on one pod, the serve
# phase's traffic, against model = 1 on the same weights and prompts
MODEL_SERVE = dict(batch=16, prompt_len=1024, gen_len=64, n_requests=32,
                   n_pods=1, mode="numapte", model=2, top_k=8,
                   max_flip_share=MAX_FLIP_SHARE)
# B: Yi-6B at the train phase's cut (8 of 32 layers, batch 8 x 1 024),
# 4 steps at model = 2 against model = 1
MODEL_TRAIN = dict(arch="yi_6b", n_layers=8, batch=8, seq=1024, steps=4,
                   model=2, loss_tol=MODEL_TRAIN_LOSS_TOL)
# C: Yi-6B (2 of 32 layers): 6 steps at (data 2, model 4), a checkpoint,
# 4 more there and 4 restored onto (data 2, model 2)
ELASTIC = dict(arch="yi_6b", n_layers=2, batch=8, seq=1024, first=6, then=4,
               grid_a=(2, 4), grid_b=(2, 2), ref_tol=2e-2,
               loss_tol=ELASTIC_LOSS_TOL)


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


def model_axis_serve(pools: int = 1) -> dict:
    """A: ``serve()`` of Qwen3-14B at model = 1 and at model = 2 (the same
    seeded bf16 weights, split by ``shard_params`` after the first run has
    let its copy go: both at once would need 59 GB beside the slabs), the
    same prompts.  The first decode step's logits within 0.03, tokens equal
    but for first flips at near-ties (model = 1's margin no larger than
    the first step's largest logit difference), K1 and K2 once a shard a
    layer, K3 as at model = 1.  F1 (``pools`` = 4): both runs over 4 KV
    pools on 4 pods (each row's frames in its pod's pool; at model 2 each
    shard's kv heads of the pooled slab), the model axis's bytes a step
    against ``analysis.model_wire`` of the decode cell."""
    t_part = time.perf_counter()
    cfg = get_config("qwen3_14b")
    traffic = {k: MODEL_SERVE[k] for k in ("batch", "prompt_len", "gen_len",
                                           "n_requests", "n_pods", "mode")}
    tag = "model_axis_serve"
    if pools > 1:
        traffic.update(n_pods=pools, n_pools=pools)
        tag = "model_axis_pooled"
    t = MODEL_SERVE["model"]
    runs, rows = {}, {}
    for model in (1, t):
        release()
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                             param_dtype=cfg.dtype)
        if model > 1:
            params = specs.shard_params(
                params, make_debug_mesh(1, model=model, device=DEV), cfg)
            release()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        with lse_pointers_counted({}) as lse:
            r = serve("qwen3_14b", full_width=True, cfg=cfg, params=params,
                      verbose=False, model=model,
                      trace_logits=MODEL_SERVE["top_k"], **traffic)
        counts = counts_now()
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params
        want = expected_launches(cfg, waves=2, gen_len=traffic["gen_len"],
                                 warm_up=True)
        want["paged_attention"] *= model
        want["flash_attention"] *= model
        check(counts == want and lse["lse_writes"] == 0,
              f"model {model}: launch counts {counts}, the path implies "
              f"{want}; LSE writes {lse}")
        check(r["logits_finite"] and r["tokens"] == traffic["n_requests"]
              * traffic["gen_len"], f"model {model}: {r['tokens']} tokens")
        runs[f"{tag}_{model}"] = (counts, want)
        rows[model] = r
    one, two = rows[1], rows[t]
    extra = {}
    if pools > 1:
        cell = specs.build_cell("qwen3_14b", tconfigs.ShapeSpec(
            "decode_f1", traffic["prompt_len"], traffic["batch"], "decode"),
            make_debug_mesh(1, model=t, device="meta"), cfg=cfg)
        wire = analysis.model_wire(cell)
        check(two["model_wire_bytes_per_step"] == wire,
              f"F1: {two['model_wire_bytes_per_step']} model-axis bytes a "
              f"step, analysis.model_wire {wire}")
        extra = {"model_wire_bytes_per_step_analytic": wire,
                 "n_pools": pools, "kv_layout_model_2": two["kv_layout"]}
    first_err = float(np.abs(two["first_logits"] - one["first_logits"]).max())
    first_rel = first_err / float(np.abs(one["first_logits"]).max())
    flips = first_flips(one["token_ids"], two["token_ids"],
                        (one["top_values"], one["top_ids"]),
                        (two["top_values"], two["top_ids"]))
    at_tie = [f["margin_model1"] is not None and f["margin_model1"] <= first_err
              for f in flips]
    equal_rows = int((one["token_ids"] == two["token_ids"]).all(axis=1).sum())
    # decisions compared: a row's steps up to and including its first flip
    compared = int(sum(f["step"] + 1 for f in flips)
                   + equal_rows * traffic["gen_len"])
    check(first_rel <= 0.03, f"model {t}: first-step logits rel {first_rel}")
    check(all(at_tie) and len(flips) <= MODEL_SERVE["max_flip_share"] * compared,
          f"model {t}: token flips {flips} in {compared} compared decisions "
          f"(at most a share {MODEL_SERVE['max_flip_share']}, each at a margin "
          f"<= {first_err})")
    keep = ("prefill_ms", "decode_step_ms", "tok_per_s", "peak_mem_gb",
            "model_wire_bytes_per_step", "model_calls", "kv_layout",
            "fetches", "invalidations_sent")
    emit({"phase": tag, "arch": "qwen3_14b",
          "widths": "published", "layers": cfg.n_layers, **MODEL_SERVE,
          **traffic, **extra, "grid": {"pod": 1, "data": 1, "model": t},
          "logits_traced": "every step's top-k is gathered for the flip "
                           "check; its bytes are not counted as the step's",
          "first_step_logits_rel_err": first_rel,
          "first_step_logits_max_abs_err": first_err,
          "rows_token_equal": equal_rows, "rows": traffic["n_requests"],
          "decisions_compared": compared, "flips": len(flips),
          "flip_share": len(flips) / compared,
          "flip_margins_model1": sorted(f["margin_model1"] for f in flips),
          "first_flips": flips, "launches": {m: runs[f"{tag}_{m}"][0]
                                             for m in (1, t)},
          "model_1": {k: one.get(k) for k in keep},
          f"model_{t}": {k: two.get(k) for k in keep},
          "wall_s": time.perf_counter() - t_part})
    del rows, one, two
    release()
    return runs


def grid_train(cfg, ds, grid, steps, params=None, opt=None, start=0):
    """``steps`` train steps of ``build_train_step`` over ``grid`` (from
    seed 0's weights, split over its model axis, unless ``params`` / ``opt``
    are given) from batch ``start``; each step's wall time ends with
    ``float(loss)``."""
    if params is None:
        params = specs.shard_params(init_params(
            cfg, torch.Generator(device=DEV).manual_seed(0)), grid, cfg)
        opt = adamw_init(params)
    step = specs.build_train_step(cfg, pods=grid, remat=False)
    losses, step_s = [], []
    for i in range(start, start + steps):
        batch = {k: torch.from_numpy(v).to(DEV)
                 for k, v in ds.batch_at(i).items()}
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    return params, opt, losses, step_s


def model_axis_train() -> dict:
    """B: Yi-6B (8 of 32 layers, float32 master weights) 4 steps at
    model = 1 and at model = 2 from the same weights and batches."""
    t_part = time.perf_counter()
    cfg = dataclasses.replace(get_config(MODEL_TRAIN["arch"]),
                              n_layers=MODEL_TRAIN["n_layers"])
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=MODEL_TRAIN["seq"],
                            global_batch=MODEL_TRAIN["batch"])
    steps, t = MODEL_TRAIN["steps"], MODEL_TRAIN["model"]
    runs, out = {}, {}
    for model in (1, t):
        release()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        with lse_pointers_counted({}) as lse:
            params, opt, losses, step_s = grid_train(
                cfg, ds, make_debug_mesh(1, model=model, device=DEV), steps)
        counts = counts_now()
        want = uncapped({"paged_attention": 0,
                         "flash_attention": cfg.n_layers * steps * model,
                         "flash_attention_bwd": cfg.n_layers * steps * model,
                         "pte_gather": 0, "fifo_miss": 0})
        check(counts == want and lse["lse_writes"] == want["flash_attention"],
              f"train at model {model}: launches {counts} lse {lse}, not {want}")
        step_ms = 1e3 * float(np.median(step_s))
        out[model] = {"losses": losses, "step_ms": [1e3 * x for x in step_s],
                      "step_ms_median": step_ms,
                      "tokens_per_s": MODEL_TRAIN["batch"] * MODEL_TRAIN["seq"]
                      / (step_ms / 1e3),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": counts}
        runs[f"model_axis_train_{model}"] = (counts, want)
        del params, opt
    diff = max(abs(a - b) for a, b in zip(out[1]["losses"], out[t]["losses"]))
    check(all(np.isfinite(out[t]["losses"])) and diff <= MODEL_TRAIN["loss_tol"],
          f"train at model {t}: losses {out[t]['losses']} against "
          f"{out[1]['losses']}: {diff} > {MODEL_TRAIN['loss_tol']}")
    emit({"phase": "model_axis_train", "arch": MODEL_TRAIN["arch"],
          "widths": "published", **MODEL_TRAIN,
          "grid": {"pod": 1, "data": 1, "model": t},
          "param_dtype": "float32", "dtype": "bfloat16",
          "loss_max_abs_diff": diff, "model_1": out[1], f"model_{t}": out[t],
          "wall_s": time.perf_counter() - t_part})
    release()
    return runs


def model_axis_elastic() -> dict:
    """C: Yi-6B (2 of 32 layers) 6 steps at (data 2, model 4), a checkpoint
    (its leaves must equal a gather of the live shards, bit for bit), 4
    more steps there, and 4 restored onto (data 2, model 2): the two last-4
    trajectories within the reference's 2e-2 and the bound from readings."""
    t_part = time.perf_counter()
    cfg = dataclasses.replace(get_config(ELASTIC["arch"]),
                              n_layers=ELASTIC["n_layers"])
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=ELASTIC["seq"],
                            global_batch=ELASTIC["batch"])
    grid_a = make_debug_mesh(1, data=ELASTIC["grid_a"][0],
                             model=ELASTIC["grid_a"][1], device=DEV)
    grid_b = make_debug_mesh(1, data=ELASTIC["grid_b"][0],
                             model=ELASTIC["grid_b"][1], device=DEV)
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        params, opt, first, _ = grid_train(cfg, ds, grid_a, ELASTIC["first"])
        ckpt = CheckpointManager(root, async_save=False)
        t0 = time.perf_counter()
        ckpt.save(ELASTIC["first"], {"params": params, "opt": opt}, grid=grid_a)
        save_s = time.perf_counter() - t0
        live = specs.gather_params({"params": params, "opt": opt}, grid_a)
        entries = json.loads(open(os.path.join(
            root, f"step_{ELASTIC['first']}", "manifest.json")).read())["leaves"]
        by_name = {"/".join(p): leaf for p, leaf in tree_leaves_with_path(live)}
        for e in entries:
            stored = np.load(os.path.join(root, f"step_{ELASTIC['first']}",
                                          f"leaf_{e['i']}.npy"))
            held = by_name[e["name"]].detach().cpu().numpy()
            check(stored.shape == held.shape and stored.tobytes() == held.tobytes(),
                  f"checkpoint leaf {e['name']} is not the gathered live leaf")
        del live, by_name
        params, opt, uninterrupted, _ = grid_train(
            cfg, ds, grid_a, ELASTIC["then"], params, opt, ELASTIC["first"])
        del params, opt
        release()
        whole = init_params(cfg, SHAPES_ONLY)
        t0 = time.perf_counter()
        state = ckpt.restore(ELASTIC["first"],
                             {"params": whole, "opt": adamw_init(whole)},
                             device=DEV, grid=grid_b, cfg=cfg)
        restore_s = time.perf_counter() - t0
        _, _, resumed, _ = grid_train(cfg, ds, grid_b, ELASTIC["then"],
                                      state["params"], state["opt"],
                                      ELASTIC["first"])
        del state
    finally:
        shutil.rmtree(root)
    counts = counts_now()
    da, ma = ELASTIC["grid_a"]
    db, mb = ELASTIC["grid_b"]
    k2 = cfg.n_layers * ((ELASTIC["first"] + ELASTIC["then"]) * da * ma
                         + ELASTIC["then"] * db * mb)
    want = uncapped({"paged_attention": 0, "flash_attention": k2,
                     "flash_attention_bwd": k2, "pte_gather": 0, "fifo_miss": 0})
    check(counts == want, f"elastic: launches {counts}, not {want}")
    drift = max(abs(a - b) for a, b in zip(uninterrupted, resumed))
    check(all(np.isfinite(resumed)) and drift <= ELASTIC["loss_tol"]
          and drift < ELASTIC["ref_tol"],
          f"elastic: restored {resumed} against {uninterrupted}: {drift}")
    emit({"phase": "model_axis_elastic", "arch": ELASTIC["arch"],
          "widths": "published", **ELASTIC, "losses_first": first,
          "losses_uninterrupted": uninterrupted, "losses_restored": resumed,
          "drift": drift, "checkpoint_equals_gathered_shards": True,
          "checkpoint_leaves": len(entries),
          "checkpoint_gb": sum(int(np.prod(e["shape"])) * (2 if e["dtype"] ==
                               "bfloat16" else np.dtype(e["dtype"]).itemsize)
                               for e in entries) / 1e9,
          "save_s": save_s, "restore_s": restore_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts, "wall_s": time.perf_counter() - t_part})
    release()
    return {"model_axis_elastic": (counts, want)}


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


def model_axis_wire(cfg, params, batch: int, t: int) -> int:
    """The model axis's bytes of one decode step of ``batch`` rows, from the
    shapes, counted as ``Pods`` counts them (each collective's per-shard
    slice, received by t - 1 shards, on each of t): the vocab-parallel
    embedding's psum [B, D]; a layer's row-parallel psums [B, D] (split
    attention, cross-attention, FFN, experts with their split shared
    expert, SSD, RG-LRU); the MoE's gather of the router logits [B, E];
    the SSD's gather of B / C [B, 2n] and psum of the norm's sums of
    squares [B] (float32); the RG-LRU's gather of xb [B, w]; greedy's
    gathers of each shard's best logit and its index (int64)."""
    el = torch.tensor([], dtype=cfg.dtype).element_size()
    row = batch * cfg.d_model * el
    split = lambda leaf: leaf.dim() == 3
    total = row if split(params["embedding"]) else 0
    for gp in params["groups"]:
        for lp in gp:
            if "ssd" in lp and lp["ssd"]["in_proj"].dim() == 3:
                total += batch * 2 * cfg.ssm_state // t * el + batch * 4 + row
            if "rglru" in lp and lp["rglru"]["rg_in"].dim() == 3:
                total += batch * lp["rglru"]["rg_in"].shape[-1] * el + row
            for name in ("attn", "cross"):
                if name in lp and split(lp[name]["wq"]):
                    total += row
            if "ffn" in lp and split(lp["ffn"]["w_in"]):
                total += row
            if "moe" in lp:
                m = lp["moe"]
                if m["we_in"].dim() == 4:
                    total += batch * cfg.n_experts // t * el + row
                elif "shared" in m and split(m["shared"]["w_in"]):
                    total += row
    if split(params.get("lm_head", params["embedding"])):
        total += batch * el + batch * 8
    return t * (t - 1) * total


def serve_models(arch, cfg, params, traffic, t, routes, tag=""):
    """``serve()`` at model = 1, then ``params`` split in place over a model
    axis of t and ``serve()`` at model = t, the same prompts, each traced
    (``trace_logits``) and with its MoE routes appended to ``routes[model]``;
    returns (the two results, the launch counts of each beside what the path
    implies, the split params)."""
    grid = make_debug_mesh(1, model=t, device=DEV)
    runs, rows = {}, {}
    for model in (1, t):
        shards = 1
        if model > 1:
            params = shard_in_place(params, grid, cfg)
            release()
            shards = heads_shards(params, t)
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        # MoE: model = t takes model = 1's expert ids (its own picks are
        # recorded), so the logits compare the same routes: a route that
        # flips at a near-tie would move a token's output by far more than
        # the logits' bound (the parity phase does the same)
        follow = routes[1] if model > 1 and cfg.n_experts else None
        with lse_pointers_counted({}) as lse, routes_recorded(
                routes[model], follow=follow, per_call=model):
            r = serve(arch, full_width=True, cfg=cfg, params=params,
                      verbose=False, model=model,
                      trace_logits=FAMILIES["top_k"], **traffic)
        counts = counts_now()
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        want = expected_launches(cfg, waves=2, gen_len=traffic["gen_len"],
                                 warm_up=True, shards=shards)
        check(counts == want and lse["lse_writes"] == 0,
              f"{arch}{tag} model {model}: launch counts {counts}, the path "
              f"implies {want}; LSE writes {lse}")
        check(r["logits_finite"] and r["tokens"] == traffic["n_requests"]
              * traffic["gen_len"], f"{arch} model {model}: {r['tokens']} tokens")
        runs[f"model_axis_{arch}{tag}_{model}"] = (counts, want)
        r["launches"], r["heads_shards"] = counts, shards
        rows[model] = r
    return rows, runs, params


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


def loose_to_model_one(one, two) -> dict:
    """The same readings as ``held_to_model_one``, unchecked."""
    first_err = float(np.abs(two["first_logits"] - one["first_logits"]).max())
    return {"first_step_logits_rel_err":
            first_err / float(np.abs(one["first_logits"]).max()),
            "rows_token_equal": int((one["token_ids"] == two["token_ids"])
                                    .all(axis=1).sum())}


SERVE_KEEP = ("prefill_ms", "decode_step_ms", "tok_per_s", "peak_mem_gb",
              "model_wire_bytes_per_step", "model_calls", "kv_layout",
              "launches", "heads_shards", "fetches")


def family_serve(arch: str, n_layers) -> dict:
    """One arch of D: ``serve_models`` on the seeded bf16 weights, the
    model axis's bytes a step against the count from the shapes, and the
    first-step logits and flips held to model = 1.  An arch in
    ``FAMILIES["held_in_float32"]`` is held in float32 instead, on the same
    weights cast once (``serve_models`` again): its random-weight model in
    bf16 turns any change in the order of the roundings into logits
    further apart than the bound (its bf16 readings are emitted, not
    held).  Returns the launch counts of each run beside what its path
    implies."""
    t_arch = time.perf_counter()
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    traffic = {k: MODEL_SERVE[k] for k in ("batch", "prompt_len", "gen_len",
                                           "n_requests", "n_pods", "mode")}
    t = FAMILIES["model"]
    seeded = lambda dt: init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                                    param_dtype=torch.bfloat16 if dt is None else dt)
    release()
    routes = {1: [], t: []}
    rows, runs, params = serve_models(arch, cfg, seeded(None), traffic, t, routes)
    wire = model_axis_wire(cfg, params, traffic["batch"], t)
    del params
    one, two = rows[1], rows[t]
    check(two["model_wire_bytes_per_step"] == wire,
          f"{arch}: {two['model_wire_bytes_per_step']} model-axis bytes a "
          f"step, the shapes give {wire}")
    out = {"phase": "model_axis_family", "arch": arch, "widths": "published",
           "layers": cfg.n_layers, "layers_published": get_config(arch).n_layers,
           "reduced": ([] if n_layers is None else
                       [f"depth {n_layers} of {get_config(arch).n_layers} "
                        "layers (SERVE_DEPTH: the weights of more do not fit "
                        "the card)"]),
           **traffic, "grid": {"pod": 1, "data": 1, "model": t},
           "rules": dict(cfg.rule_overrides) or "SINGLE_POD_RULES",
           "model_wire_bytes_per_step_analytic": wire,
           "model_1": {k: one.get(k) for k in SERVE_KEEP},
           f"model_{t}": {k: two.get(k) for k in SERVE_KEEP}}
    if arch in FAMILIES["held_in_float32"]:
        out["bf16_unheld"] = loose_to_model_one(one, two)
        bf16_one = one["first_logits"]
        del rows, one, two
        release()
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        f32 = tree_map(lambda p: p.float(), seeded(None))
        rows, more, _ = serve_models(arch, cfg32, f32, traffic, t,
                                     {1: [], t: []}, tag="_f32")
        del f32
        runs.update(more)
        one, two = rows[1], rows[t]
        out["bf16_unheld"]["model1_bf16_vs_float32_rel"] = float(
            np.abs(bf16_one - one["first_logits"]).max()
            / np.abs(one["first_logits"]).max())
        out["held_in"] = "float32 (the seeded bf16 weights, cast once)"
        out["float32"] = {"model_1": {k: one.get(k) for k in SERVE_KEEP},
                          f"model_{t}": {k: two.get(k) for k in SERVE_KEEP}}
    else:
        out["held_in"] = "bfloat16"
    out.update(held_to_model_one(arch, one, two, t, traffic["gen_len"]))
    del rows, one, two
    if cfg.n_experts:
        from repro_torch.models.moe import NEAR_TIE
        mine = routes[t]
        check(len(mine) == t * len(routes[1]) and all(
            torch.equal(mine[c * t].eids, mine[c * t + s].eids)
            for c in range(len(routes[1])) for s in range(1, t)),
            f"{arch}: the shards of a MoE call routed differently")
        # the first MoE layer's calls of the warm-up and the first wave's
        # prefill read inputs that no route decided: their own picks may
        # differ from model = 1's only at near-ties
        per_pass = sum(g.n_layers for g in layer_groups(cfg) if g.moe)
        firsts = [0, 2 * per_pass]
        first = route_agreement([routes[1][c] for c in firsts],
                                [mine[c * t] for c in firsts])
        check(first["largest_gap"] < NEAR_TIE,
              f"{arch}: a first-MoE-layer route differs at no near-tie: {first}")
        out.update(route_agreement(routes[1], mine[::t]),
                   first_moe_layer_prefills=first,
                   routes="model = t follows model = 1's expert ids; "
                          "route_agreement is its own picks'")
    del routes
    out["wall_s"] = time.perf_counter() - t_arch
    emit(out)
    release()
    return runs


def family_whisper() -> dict:
    """Whisper-base through ``whisper_serve`` at model = 1 and at model = t
    on the same weights: its rules split nothing, so every step's logits
    and every token must be bit-equal, and the kernels launch as often."""
    t_arch = time.perf_counter()
    arch, spec, t = "whisper_base", WHISPER, FAMILIES["model"]
    cfg = get_config(arch)
    grid = make_debug_mesh(1, model=t, device=DEV)
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    split = specs.shard_params(params, grid, cfg)
    check(not any(specs.split_leaves(split)), "Whisper's rules split a leaf")
    runs, rows = {}, {}
    for model in (1, t):
        reset_counters()
        grid.model.reset_counters()
        r = whisper_serve(cfg, split if model > 1 else params, **spec,
                          grid=grid if model > 1 else None, keep_logits=True)
        counts = counts_now()
        want = expected_launches(cfg, -(-spec["n_requests"] // spec["batch"]),
                                 spec["gen_len"], warm_up=False)
        check(counts == want, f"{arch} model {model}: launch counts {counts}, "
              f"the path implies {want}")
        runs[f"model_axis_{arch}_{model}"] = (counts, want)
        r["launches"] = counts
        rows[model] = r
    one, two = rows[1], rows[t]
    equal = (np.array_equal(one["token_ids"], two["token_ids"])
             and all(torch.equal(a, b) for a, b in zip(one["logits"],
                                                       two["logits"])))
    check(equal and len(one["logits"]) == len(two["logits"]),
          f"{arch}: model {t} is not bit-equal to model 1")
    keep = ("prefill_ms", "decode_step_ms", "tok_per_s", "launches")
    emit({"phase": "model_axis_family", "arch": arch, "widths": "published",
          "layers": cfg.n_layers, "reduced": [], **spec,
          "grid": {"pod": 1, "data": 1, "model": t},
          "rules": dict(cfg.rule_overrides), "split_leaves": 0,
          "bit_equal": {"tokens": int(one["token_ids"].size),
                        "logit_steps": len(one["logits"])},
          "model_wire_bytes": grid.model.wire_bytes,
          "model_wire_bytes_per_step_analytic": 0,
          "model_1": {k: one.get(k) for k in keep},
          f"model_{t}": {k: two.get(k) for k in keep},
          "wall_s": time.perf_counter() - t_arch})
    check(grid.model.wire_bytes == 0, "Whisper's model axis moved bytes")
    del params, split, rows, one, two
    release()
    return runs


def model_axis_families() -> dict:
    t_part = time.perf_counter()
    runs = {}
    for arch, depth in FAMILIES["archs"].items():
        runs.update(family_serve(arch, depth))
    runs.update(family_whisper())
    emit({"phase": "model_axis_families", "archs": list(FAMILIES["archs"])
          + ["whisper_base"], "wall_s": time.perf_counter() - t_part})
    return runs


# E: Megatron sequence parallelism at model 2: Yi-6B trained (part B's cut,
# no remat) and Qwen3-14B's prefill (8 of 40 layers, 16 x 1 024), each with
# and without, as the dry run's cells on the card
MODEL_SP = dict(train=("yi_6b", 8, 8, 1024, 4), prefill=("qwen3_14b", 8, 16, 1024),
                model=2)
# only the norm scales' gradients may differ with SP: each shard sums its rows'
# share and the shares are added, a sum in another order (read: <= 3.5e-7 of
# the leaf's largest); the losses of steps 2-4 then drift by as much (read:
# 2.0e-5 at step 4)
SP_GRAD_TOL_REL = 1e-5
SP_LOSS_TOL = 1e-4


def sp_grad_diff(n_layers: int = 2) -> dict:
    """Part E's train cell cut to ``n_layers``: its first gradients with and
    without sequence parallelism, each leaf whose gradients differ and by
    how much (relative to the leaf's largest)."""
    arch, _, B, S, _ = MODEL_SP["train"]
    grads, names, losses = {}, None, {}
    for sp in (False, True):
        release()
        grid = make_debug_mesh(1, model=MODEL_SP["model"], device=DEV)
        cell = specs.build_cell(arch, tconfigs.ShapeSpec("train_sp", S, B, "train"),
                                grid, device=DEV, n_layers=n_layers,
                                opts=specs.PerfOptions(seq_parallel=sp, remat=False))
        params, _, batch = cell.args
        with use_rules(specs.make_rules(cell.cfg, grid, cell.opts)):
            grads[sp], m = specs.data_gradients(cell.cfg, params, batch, grid,
                                                remat=False)
        losses[sp] = float(m["loss"])
        names = ["/".join(p) for p, _ in tree_leaves_with_path(params)]
        del cell, params, batch
    diffs = sorted((float((a - b).abs().max() / b.abs().max()), name)
                   for name, a, b in zip(names, grads[True], grads[False])
                   if not torch.equal(a, b))
    del grads
    return {"layers": n_layers, "loss_equal": losses[True] == losses[False],
            "leaves": len(names), "leaves_differing": len(diffs),
            "differing": [[n, r] for r, n in diffs]}


def model_axis_sp() -> dict:
    """E: the train and prefill cells (``specs.build_cell`` on the card over
    a grid of one pod, model 2) with ``seq_parallel`` beside without: the
    train losses bit-equal (or printed with the reason), the prefill's
    logits equal, each step's model-axis bytes equal to ``model_wire`` of
    its cell; step ms and launches a step."""
    t_part = time.perf_counter()
    t = MODEL_SP["model"]
    arch, L, B, S, steps = MODEL_SP["train"]
    out, runs = {"train": {}, "prefill": {}}, {}
    for sp in (False, True):
        release()
        grid = make_debug_mesh(1, model=t, device=DEV)
        cell = specs.build_cell(arch, tconfigs.ShapeSpec("train_sp", S, B, "train"),
                                grid, device=DEV, n_layers=L,
                                opts=specs.PerfOptions(seq_parallel=sp, remat=False))
        params, opt, batch = cell.args
        losses, step_s, wires = [], [], []
        reset_counters()
        for _ in range(steps):
            grid.model.reset_counters()
            t0 = time.perf_counter()
            params, opt, m = cell.step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
            wires.append(grid.model.wire_bytes)
        counts = counts_now()
        want_wire = analysis.model_wire(cell)
        check(all(w == want_wire for w in wires),
              f"E train sp={sp}: wire {wires}, model_wire {want_wire}")
        want = uncapped({"paged_attention": 0, "flash_attention": L * steps * t,
                         "flash_attention_bwd": L * steps * t, "pte_gather": 0,
                         "fifo_miss": 0})
        check(counts == want, f"E train sp={sp}: launches {counts}, not {want}")
        runs[f"model_axis_sp_train_{sp}"] = (counts, want)
        out["train"]["sp" if sp else "base"] = {
            "losses": losses, "step_ms": [1e3 * x for x in step_s],
            "step_ms_median": 1e3 * float(np.median(step_s)),
            "wire_bytes_per_step": wires[0], "model_wire": want_wire,
            "seq_split": cell.seq_split, "calls": dict(grid.model.calls)}
        del cell, params, opt, batch
    base, spr = out["train"]["base"], out["train"]["sp"]
    out["train"]["losses_bit_equal"] = base["losses"] == spr["losses"]
    out["train"]["loss_max_abs_diff"] = max(
        abs(a - b) for a, b in zip(base["losses"], spr["losses"]))
    check(base["losses"][0] == spr["losses"][0],
          f"E: the first step's loss differs with SP: {out['train']}")
    check(out["train"]["loss_max_abs_diff"] <= SP_LOSS_TOL,
          f"E: losses with SP {spr['losses']}, without {base['losses']}")
    grads = out["train"]["first_gradients"] = sp_grad_diff()
    check(grads["loss_equal"]
          and all(n.endswith("norm1/scale") or n.endswith("norm2/scale")
                  or n == "final_norm/scale" for n, _ in grads["differing"])
          and all(r <= SP_GRAD_TOL_REL for _, r in grads["differing"]),
          f"E: the first gradients with SP differ beyond the norm scales' "
          f"sums, or by more than {SP_GRAD_TOL_REL}: {grads}")
    arch, L, B, S = MODEL_SP["prefill"]
    logits = {}
    for sp in (False, True):
        release()
        grid = make_debug_mesh(1, model=t, device=DEV)
        cell = specs.build_cell(arch, tconfigs.ShapeSpec("prefill_sp", S, B, "prefill"),
                                grid, device=DEV, n_layers=L,
                                opts=specs.PerfOptions(seq_parallel=sp))
        reset_counters()
        grid.model.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, _ = cell.step_fn(*cell.args)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        wire, want_wire = grid.model.wire_bytes, analysis.model_wire(cell)
        check(wire == want_wire, f"E prefill sp={sp}: wire {wire}, "
                                 f"model_wire {want_wire}")
        counts = counts_now()
        want = uncapped({"paged_attention": 0, "flash_attention": L * t,
                         "flash_attention_bwd": 0, "pte_gather": 0,
                         "fifo_miss": 0})
        check(counts == want, f"E prefill sp={sp}: launches {counts}, not {want}")
        runs[f"model_axis_sp_prefill_{sp}"] = (counts, want)
        params, state, toks, tables = cell.args
        with torch.no_grad(), use_rules(specs.make_rules(cell.cfg, grid,
                                                         cell.opts)):
            lg, _ = specs.prefill_on_grid(cell.cfg, params, toks, state, tables,
                                          grid)
        logits[sp] = gather_vocab(lg, grid.model).float()
        out["prefill"]["sp" if sp else "base"] = {
            "ms": ms, "wire_bytes": wire, "model_wire": want_wire,
            "seq_split": cell.seq_split, "tokens": tokens.tolist(),
            "launches": counts}
        del cell, params, state, toks, tables, lg
    diff = float((logits[True] - logits[False]).abs().max())
    out["prefill"]["logits_max_abs_diff"] = diff
    check(diff == 0.0, f"E: prefill logits with SP differ by {diff}")
    check(out["prefill"]["sp"]["tokens"] == out["prefill"]["base"]["tokens"],
          "E: prefill tokens with SP differ")
    del logits
    release()
    emit({"phase": "model_axis_sp", "widths": "published", "model": t,
          "train_arch": MODEL_SP["train"][0], "train_layers": MODEL_SP["train"][1],
          "prefill_arch": arch, "prefill_layers": L, **out,
          "wall_s": time.perf_counter() - t_part})
    return runs


# F: the grid's options of slice 16.1c at published widths.  F1 is part A
# over 4 KV pools (``model_axis_serve(pools=POOLS)``).  F2: part B's context
# decoded sequence-parallel at model 2.  F3: the data axis over the caches
# held a row, data 2 x model 2 beside data 1 x model 2, part D's archs,
# depths and bounds (Mamba-2 held in float32, as in D), one wave of part D's
# traffic (cut from two: both runs serve the same rows).  F4: the other
# families' train steps at model 2 beside model 1, each a train cell on the
# card (float32 weights and AdamW from seed 0, remat "full" as the
# reference's step), 4 steps on one batch of 4 x 1 024 (Whisper: 1 500
# frames); depth cut where the float32 weights, their gradients and AdamW's
# moments would not fit the card: Gemma-3-4B 8 of 34, Qwen3-235B-A22B 1 of 94
# (one MoE layer: 9.7 GB of float32 experts; it fits only with AdamW's
# update in chunks, read 74.5 GB at model 2), Kimi-K2 1 of 61 (its dense
# first layer: one MoE layer's 17 B float32 parameters need 68 GB before
# AdamW), RecurrentGemma-2B 13 of 26.  Mamba-2 is held in float32 (read in
# bf16: 5.5e-3 at the 4th step, its random-weight model amplifying the order
# of the roundings, as in part D)
# F2's model 2 against the one-pool decode carries both of its differences,
# the model axis's (part A's bound 0.03) and SP's (part B's 0.03; part B
# reads 0.0266): their sum, set after the first reading, 0.0302
SP2_REL = 0.06
DATA_AXIS = dict(archs={"gemma3_4b": None, "recurrentgemma_2b": None,
                        "mamba2_370m": None},
                 data=2, model=2, n_requests=16,
                 held_in_float32=("mamba2_370m",))
FAMILY_TRAIN = dict(archs={"gemma3_4b": 8, "qwen3_moe_235b_a22b": 1,
                           "kimi_k2_1t_a32b": 1, "mamba2_370m": None,
                           "recurrentgemma_2b": 13, "whisper_base": None},
                    batch=4, seq=1024, enc_frames=1500, steps=4, model=2,
                    remat="full", loss_tol=MODEL_TRAIN_LOSS_TOL,
                    held_in_float32=("mamba2_370m",))


@torch.no_grad()
def model_axis_sp_decode() -> dict:
    """F2: part B's context (Qwen3-14B, 32 768 tokens, one row) prefilled
    into one pool and moved into the SP column layout over 4 pools, then
    decoded sequence-parallel over ``make_debug_mesh(4)`` at model 1 (its
    own greedy tokens), the one-pool decode fed the same tokens, and at
    model 2 (the weights split in place; each shard's heads over the pools,
    K1 with ``kv_heads`` and the LSE, each shard's partials combined) fed
    them too, each SP run from a copy of the moved state.  Model 2 is held
    to model 1's SP decode within part A's rel 0.03, and to the one-pool
    decode as part B holds model 1 (at most ``SP["max_flips"]`` flips, each
    at a near-tie) within ``SP2_REL`` (both differences at once); one
    layer's SP attention at model 2 timed beside model 1's."""
    t_part = time.perf_counter()
    cfg = get_config("qwen3_14b")
    t = FAMILIES["model"]
    bt, n, steps = cfg.kv_block_tokens, SP["shards"], SP["steps"]
    MB = SP["context"] // bt
    MBl = MB // n
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    torch.cuda.reset_peak_memory_stats()
    kv = PagedKVManager(n_frames=MB, block_tokens=bt, max_blocks_per_seq=MB,
                        n_pods=n, device=DEV)
    kv.start_sequence(0, SP["context"])
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, SP["context"] - steps))).to(DEV, torch.int32)
    reset_counters()
    phys = kv.physical_tables([0])
    one = init_decode_state(cfg, 1, MB, MB)
    logits, one = prefill(cfg, params, prompt, one, phys)
    moved = init_decode_state(cfg, 1, MB, MB, n_pools=n)
    for name in ("k_slabs", "v_slabs"):
        for s_ in range(n):
            moved.caches[0][name][:, s_] = \
                one.caches[0][name][:, phys[0, s_ * MBl:(s_ + 1) * MBl].long()]
    moved = moved._replace(seq_lens=one.seq_lens.clone())
    local = (torch.arange(MB, device=DEV) % MBl).to(torch.int32)[None]
    first = greedy_sample(logits)

    def sp_decode(grid, feed=None):
        """SP decode over ``grid`` from a copy of the moved state, fed
        ``feed`` (or its own greedy tokens): its logits, whole, and the
        tokens fed."""
        st = moved._replace(caches=tuple({k: v.clone() for k, v in c.items()}
                                         for c in moved.caches))
        kept = []

        def keep(lg):
            whole = gather_vocab(lg, grid.model) if lg.dim() == 3 else lg
            kept.append(whole.float())
            return greedy_sample(whole)

        step = specs.build_serve_step(cfg, sp=True, pods=grid, sample=keep)
        tok, fed = first, []
        for i in range(steps):
            tok = tok if feed is None else feed[i]
            fed.append(tok)
            tok, st = step(params, st, tok, local)
        torch.cuda.synchronize()
        return kept, fed

    runs = {}
    grid1 = make_debug_mesh(n, device=DEV)
    l1, fed = sp_decode(grid1)
    counts = counts_now()
    want = uncapped({"paged_attention": cfg.n_layers * n * steps,
                     "flash_attention": cfg.n_layers, "flash_attention_bwd": 0,
                     "pte_gather": 1, "fifo_miss": 0})
    check(counts == want, f"F2 model 1: launches {counts}, not {want}")
    runs["model_axis_sp_decode_1"] = (counts, want)
    reset_counters()
    l0 = []
    for tok in fed:
        lg, one = decode_step(cfg, params, one, tok, phys)
        l0.append(lg.float())
    torch.cuda.synchronize()
    counts = counts_now()
    want = uncapped({"paged_attention": cfg.n_layers * steps,
                     "flash_attention": 0, "flash_attention_bwd": 0,
                     "pte_gather": 0, "fifo_miss": 0})
    check(counts == want, f"F2 one pool: launches {counts}, not {want}")
    runs["model_axis_sp_one_pool"] = (counts, want)
    del one
    release()
    grid2 = make_debug_mesh(n, model=t, device=DEV)
    shard_in_place(params, grid2, cfg)
    release()
    reset_counters()
    l2, _ = sp_decode(grid2, fed)
    counts = counts_now()
    want = uncapped({"paged_attention": cfg.n_layers * n * t * steps,
                     "flash_attention": 0, "flash_attention_bwd": 0,
                     "pte_gather": 0, "fifo_miss": 0})
    check(counts == want, f"F2 model {t}: launches {counts}, not {want}")
    runs[f"model_axis_sp_decode_{t}"] = (counts, want)
    rels, rels_1, flips = [], [], []
    for i, (a, b, c) in enumerate(zip(l2, l0, l1)):
        err = float((a - b).abs().max())
        rels.append(err / float(b.abs().max()))
        rels_1.append(float((a - c).abs().max() / c.abs().max()))
        x, y = int(b.argmax()), int(a.argmax())
        if x != y:
            flips.append({"step": i, "gap": float(b[0, x] - b[0, y]),
                          "logit_err": err})
    check(max(rels_1) <= 0.03, f"F2: SP decode at model {t} against model "
          f"1's: rel {max(rels_1)}")
    check(max(rels) < SP2_REL and len(flips) <= SP["max_flips"]
          and all(f["gap"] <= f["logit_err"] for f in flips),
          f"F2: SP decode at model {t} against the one-pool decode: rel "
          f"{max(rels)}, flips {flips} (at most {SP['max_flips']})")
    # one layer's SP attention: model t's shards (K1 with kv_heads and the
    # LSE a pool, each shard's combine) against model 1's, the same slabs
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = randn((1, H, hd), torch.bfloat16)
    kn, vn = (randn((1, K, hd), torch.bfloat16) for _ in range(2))
    ks, vs = moved.caches[0]["k_slabs"][0], moved.caches[0]["v_slabs"][0]
    pos, lens = moved.seq_lens - 1, moved.seq_lens
    pods = LoopPods(n, DEV)

    def layer(tt):
        Hs, Ks = H // tt, K // tt
        parts = [(q[:, i * Hs:(i + 1) * Hs].contiguous(),
                  kn[:, i * Ks:(i + 1) * Ks], vn[:, i * Ks:(i + 1) * Ks],
                  None if tt == 1 else (i * Ks, Ks)) for i in range(tt)]
        return lambda: [kv_gather.decode_attention_sp(
            qi, ks, vs, ki, vi, local, pos, lens, block_tokens=bt, n_kv=Ks,
            pods=pods, kv_heads=heads)[0] for qi, ki, vi, heads in parts]

    layer_err = max_err(torch.cat(layer(t)(), dim=1), layer(1)()[0])
    check(layer_err <= TOL["paged_attention"], f"F2: one layer's SP attention "
          f"at model {t} is {layer_err} off model 1's")
    ms = {m: time_ms(layer(m)) for m in (1, t)}
    emit({"phase": "model_axis_sp_decode", "arch": "qwen3_14b",
          "widths": "published", "layers": cfg.n_layers, "context": SP["context"],
          "pools": n, "decode_steps": steps, "model": t,
          "grid": {"pod": n, "data": 1, "model": t},
          "kv_layout": "replicated (Qwen3-14B's rules keep kv heads whole)",
          "logits_rel_err_max": max(rels),
          "logits_rel_err_median": float(np.median(rels)),
          "logits_rel_err_vs_model_1_sp_max": max(rels_1),
          "flips_at_near_ties": flips, "layer_sp_model_vs_model_1_err": layer_err,
          "sp_attention_layer_ms": {f"model_{m}": v for m, v in ms.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": {k: v[0] for k, v in runs.items()},
          "wall_s": time.perf_counter() - t_part})
    del params, moved, kv, l0, l1, l2
    release()
    return runs


def data_axis_family(arch: str, n_layers) -> dict:
    """F3, one decoder-only arch: ``serve()`` at data 1 and at data 2 over
    a model axis of 2, the same seeded weights (split once, in place) and
    prompts, each traced; data 2 held to data 1 by part D's bounds
    (``held_to_model_one``), and whether the two are bit-equal."""
    t_arch = time.perf_counter()
    t, d = DATA_AXIS["model"], DATA_AXIS["data"]
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    f32 = arch in DATA_AXIS["held_in_float32"]
    traffic = {k: MODEL_SERVE[k] for k in ("batch", "prompt_len", "gen_len",
                                           "n_pods", "mode")}
    traffic["n_requests"] = DATA_AXIS["n_requests"]
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=torch.bfloat16)
    if f32:                       # the seeded bf16 weights, cast once
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        params = tree_map(lambda p: p.float(), params)
    params = shard_in_place(params, make_debug_mesh(1, model=t, device=DEV), cfg)
    release()
    shards = heads_shards(params, t)
    runs, rows = {}, {}
    for data in (1, d):
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        r = serve(arch, full_width=True, cfg=cfg, params=params, verbose=False,
                  data=data, model=t, trace_logits=FAMILIES["top_k"], **traffic)
        counts = counts_now()
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        waves = -(-traffic["n_requests"] // traffic["batch"])
        want = expected_launches(cfg, waves=waves, gen_len=traffic["gen_len"],
                                 warm_up=True, shards=shards)
        for name in ("paged_attention", "flash_attention"):
            want[name] *= data               # a launch a data shard
        check(counts == want, f"F3 {arch} data {data}: launch counts {counts}, "
              f"the path implies {want}")
        check(r["logits_finite"] and r["tokens"] == traffic["n_requests"]
              * traffic["gen_len"], f"F3 {arch} data {data}: {r['tokens']} tokens")
        runs[f"model_axis_data_{arch}_{data}"] = (counts, want)
        r["launches"] = counts
        rows[data] = r
    one, two = rows[1], rows[d]
    held = held_to_model_one(arch, one, two, t, traffic["gen_len"],
                             what=f"data {d} x model {t}")
    bit_equal = bool(np.array_equal(one["first_logits"], two["first_logits"])
                     and np.array_equal(one["token_ids"], two["token_ids"]))
    keep = SERVE_KEEP + ("n_pods",)
    emit({"phase": "model_axis_data", "arch": arch, "widths": "published",
          "layers": cfg.n_layers, "reduced": ["one wave of part D's traffic "
                                              "(16 of 32 requests)"],
          **traffic, "grid": {"pod": 1, "data": d, "model": t},
          "held_in": "float32" if f32 else "bfloat16",
          "caches_held_a_row": sorted({n for c in init_decode_state(
              cfg, 1, 4, 2, device="meta").caches for n in c
              if n in ("ring_k", "h", "conv", "cross_k")}),
          "bit_equal": bit_equal, **held,
          "data_1": {k: one.get(k) for k in keep},
          f"data_{d}": {k: two.get(k) for k in keep},
          "wall_s": time.perf_counter() - t_arch})
    del params, rows, one, two
    release()
    return runs


def data_axis_whisper() -> dict:
    """F3, Whisper-base: ``whisper_serve`` at data 1 and data 2 over a model
    axis of 2 (its rules split nothing; each data shard's rows of the cross
    K/V its own), one wave: each step's logits of the rows whose tokens so
    far are equal within part D's 0.03 of the largest, the tokens equal but
    for first flips at near-ties (data 1's margin within twice that step's
    largest difference); after its first flip a row decodes from another
    token, so it is compared no further.  Bit-equality read."""
    t_arch = time.perf_counter()
    arch, t, d = "whisper_base", DATA_AXIS["model"], DATA_AXIS["data"]
    spec = dict(WHISPER, n_requests=WHISPER["batch"])
    cfg = get_config(arch)
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    runs, rows = {}, {}
    for data in (1, d):
        grid = make_debug_mesh(1, data=data, model=t, device=DEV)
        reset_counters()
        r = whisper_serve(cfg, specs.shard_params(params, grid, cfg), **spec,
                          grid=grid, keep_logits=True)
        counts = counts_now()
        want = expected_launches(cfg, 1, spec["gen_len"], warm_up=False)
        for name in ("paged_attention", "flash_attention"):
            want[name] *= data               # a launch a data shard
        check(counts == want, f"F3 {arch} data {data}: launch counts {counts}, "
              f"the path implies {want}")
        runs[f"model_axis_data_{arch}_{data}"] = (counts, want)
        r["launches"] = counts
        rows[data] = r
    one, two = rows[1], rows[d]
    ids1, ids2 = one["token_ids"], two["token_ids"]
    same = np.cumprod(ids1 == ids2, axis=1)        # rows equal through step s
    errs, rels = [], []
    for s_, (a, b) in enumerate(zip(one["logits"], two["logits"])):
        live = np.ones(len(ids1), bool) if s_ == 0 else same[:, s_ - 1] == 1
        live = torch.from_numpy(np.concatenate(
            [live, np.zeros(a.shape[0] - len(live), bool)])).to(a.device)
        err = float((a.float() - b.float()).abs()[live].max()) if live.any() else 0.0
        errs.append(err)
        rels.append(err / float(a.float().abs()[live].max()) if live.any() else 0.0)
    rel = max(rels)
    flips = []
    for r_ in np.nonzero((ids1 != ids2).any(axis=1))[0]:
        s_ = int(np.argmax(ids1[r_] != ids2[r_]))
        lg = one["logits"][s_][r_].float()
        gap = float(lg[int(ids1[r_, s_])] - lg[int(ids2[r_, s_])])
        flips.append({"row": int(r_), "step": s_, "margin_data_1": gap,
                      "noise": 2 * errs[s_]})
    check(rel <= 0.03 and all(f["margin_data_1"] <= f["noise"] for f in flips),
          f"F3 {arch}: data {d} logits rel {rel}, flips {flips}")
    bit_equal = bool(np.array_equal(ids1, ids2) and all(e == 0.0 for e in errs))
    keep = ("prefill_ms", "decode_step_ms", "tok_per_s", "launches")
    emit({"phase": "model_axis_data", "arch": arch, "widths": "published",
          "layers": cfg.n_layers, "reduced": ["one wave of 16 (32 in part D)"],
          **spec, "grid": {"pod": 1, "data": d, "model": t},
          "caches_held_a_row": ["cross_k", "cross_v"],
          "logits_rel_err_max": rel, "first_step_logits_rel_err": rels[0],
          "rows_token_equal": int(same[:, -1].sum()), "first_flips": flips,
          "bit_equal": bit_equal,
          "data_1": {k: one.get(k) for k in keep},
          f"data_{d}": {k: two.get(k) for k in keep},
          "wall_s": time.perf_counter() - t_arch})
    del params, rows, one, two
    release()
    return runs


def family_train(arch: str, n_layers, f32: bool = False,
                 held: bool = True) -> dict:
    """F4, one family: its train cell (``specs.build_cell``) on a grid of
    model 1 and of model 2, each from seed 0's weights and batch, 4 steps:
    losses within ``loss_tol`` of model 1's, step ms, peak GB of the steps,
    K2's forward (twice a layer a step under remat "full") and backward
    launches, once a shard where the heads split.  A MoE config's model 2
    takes model 1's expert ids, as part D's serve does (a route that flips
    at a near-tie moves a token's output past any loss bound); its own
    picks' agreement is read.  ``f32``: the config's compute in float32;
    ``held``: the losses checked (an arch of ``held_in_float32`` is held in
    float32 and its bf16 run read, as part D holds Mamba-2's serve)."""
    t_arch = time.perf_counter()
    t, steps = FAMILY_TRAIN["model"], FAMILY_TRAIN["steps"]
    S = FAMILY_TRAIN["enc_frames"] if arch == "whisper_base" else FAMILY_TRAIN["seq"]
    shape = tconfigs.ShapeSpec("train_f4", S, FAMILY_TRAIN["batch"], "train")
    cfg = get_config(arch)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    tag = "_f32" if f32 else ""
    out, runs, routes = {}, {}, {1: [], t: []}
    cut = get_config(arch)
    if n_layers is not None:
        cut = dataclasses.replace(cut, n_layers=n_layers)
    moe_cfg = any(g.moe for g in layer_groups(cut))   # Kimi-K2's 1 layer: dense
    for model in (1, t):
        release()
        grid = make_debug_mesh(1, model=model, device=DEV)
        cell = specs.build_cell(arch, shape, grid, device=DEV, n_layers=n_layers,
                                cfg=cfg,
                                opts=specs.PerfOptions(remat=FAMILY_TRAIN["remat"]))
        params, opt, batch = cell.args
        shards = heads_shards(params, model)
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        losses, step_s = [], []
        recorded = (routes_recorded(routes[model], per_call=model,
                                    follow=routes[1] if model > 1 else None)
                    if moe_cfg else contextlib.nullcontext())
        with recorded:
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = cell.step_fn(params, opt, batch)
                losses.append(float(m["loss"]))
                step_s.append(time.perf_counter() - t0)
        counts = counts_now()
        n_attn = attention_layers(cell.cfg)[1]
        want = uncapped({"paged_attention": 0,
                         "flash_attention": 2 * n_attn * steps * shards,
                         "flash_attention_bwd": n_attn * steps * shards,
                         "pte_gather": 0, "fifo_miss": 0})
        check(counts == want, f"F4 {arch} model {model}: launches {counts}, "
              f"not {want}")
        check(all(np.isfinite(losses)), f"F4 {arch} model {model}: {losses}")
        runs[f"model_axis_train_{arch}{tag}_{model}"] = (counts, want)
        out[model] = {"losses": losses, "step_ms": [1e3 * x for x in step_s],
                      "step_ms_median": 1e3 * float(np.median(step_s)),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "heads_shards": shards, "launches": counts}
        layers, cuts = cell.cfg.n_layers, dict(cell.cuts)
        del cell, params, opt, batch
    diff = max(abs(a - b) for a, b in zip(out[1]["losses"], out[t]["losses"]))
    check(diff <= FAMILY_TRAIN["loss_tol"] or not held, f"F4 {arch}: losses at "
          f"model {t} {out[t]['losses']}, at model 1 {out[1]['losses']}")
    extra = {}
    if moe_cfg:
        check(len(routes[t]) == t * len(routes[1]), f"F4 {arch}: {len(routes[t])} "
              f"routes at model {t} for {len(routes[1])} at model 1")
        extra = dict(route_agreement(routes[1], routes[t][::t]),
                     routes="model 2 follows model 1's expert ids; "
                            "route_agreement is its own picks'")
    del routes
    emit({"phase": "model_axis_train_family", "arch": arch, "widths": "published",
          "layers": layers, "layers_published": get_config(arch).n_layers,
          "reduced": [f"depth {v}" for v in cuts.values()],
          "batch": FAMILY_TRAIN["batch"], "seq": S, "remat": FAMILY_TRAIN["remat"],
          "steps": steps, "param_dtype": "float32",
          "dtype": str(cfg.dtype).replace("torch.", ""),
          "held": held, "loss_max_abs_diff": diff,
          "loss_tol": FAMILY_TRAIN["loss_tol"], **extra, "model_1": out[1],
          f"model_{t}": out[t], "step_ratio": out[t]["step_ms_median"]
          / out[1]["step_ms_median"], "wall_s": time.perf_counter() - t_arch})
    release()
    return runs


def model_axis_options() -> dict:
    """Part F (F1-F4, above)."""
    t_part = time.perf_counter()
    runs = model_axis_serve(pools=POOLS)
    runs.update(model_axis_sp_decode())
    for arch, depth in DATA_AXIS["archs"].items():
        runs.update(data_axis_family(arch, depth))
    runs.update(data_axis_whisper())
    for arch, depth in FAMILY_TRAIN["archs"].items():
        f32 = arch in FAMILY_TRAIN["held_in_float32"]
        if f32:                       # its bf16 run read, not held
            runs.update(family_train(arch, depth, held=False))
        runs.update(family_train(arch, depth, f32=f32))
    emit({"phase": "model_axis_options", "wall_s": time.perf_counter() - t_part})
    return runs


def phase_model_axis() -> dict:
    runs = model_axis_serve()
    runs.update(model_axis_train())
    runs.update(model_axis_elastic())
    runs.update(model_axis_families())
    runs.update(model_axis_sp())
    runs.update(model_axis_options())
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
                and e.device_time_total > 0
                and not e.key.startswith(tracing.PREFIX)}

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
                 and e.device_time_total > 0
                 and not e.key.startswith(tracing.PREFIX)}
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


# ------------------------------------------------------------------ cells
# (b): Yi-6B's cells as one device of the 16 x 16 grid runs them (one data
# shard's rows, the whole model on one card), each with its timed steps
CELL_RUNS = (("decode_32k", dict(), 3), ("prefill_32k", dict(), 2),
             ("train_4k", dict(rows=2), 2))
#: a run's peak of allocated memory against ``analysis.peak_bytes``
PEAK_MARGIN = 0.15


def cell_launches(cell, runs: int) -> dict:
    """What ``runs`` steps of a Yi-6B cell launch: K1 once a layer a decode
    step, K2 once a layer a prefill (no LSE), and a train step with remat
    "full" K2's forward twice a layer (the LSE each time) and its backward
    once."""
    L = cell.cfg.n_layers
    want = {name: 0 for name in COUNTED}
    step = cell.shape.step
    if step == "decode":
        want["paged_attention"] = L * runs
    elif step == "prefill":
        want["flash_attention"] = L * runs
    else:
        want["flash_attention"] = 2 * L * runs
        want["flash_attention_bwd"] = L * runs
    return want


def cells_sp() -> dict:
    """Every cell with ``seq_parallel`` on one pod and on two, on the meta
    device (bytes a device equal to the count); then the roofline table of
    train_4k and prefill_32k with SP off and on (``dryrun --table``), its
    cell files in a directory of their own."""
    t0 = time.perf_counter()
    sp = specs.PerfOptions(seq_parallel=True)
    summary = {"cells": 0, "split": 0, "dominant": {}}
    for multi in (False, True):
        grid = dryrun.production_grid(multi)
        for arch, shape in tconfigs.all_cells():
            cell = specs.build_cell(arch, tconfigs.SHAPES[shape], grid, opts=sp)
            got, want = analysis.per_device_bytes(cell), analysis.device_bytes(cell)
            check(abs(got - want) <= 1e-9 * want,
                  f"{arch} x {shape} sp: {got} bytes a device, the count {want}")
            roof = analysis.roofline(cell)
            summary["cells"] += 1
            summary["split"] += any(cell.seq_split.values())
            summary["dominant"][roof.dominant] = summary["dominant"].get(
                roof.dominant, 0) + 1
    check(summary["cells"] == 66, f"{summary['cells']} sp cells, not 2 x 33")
    summary["build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp)
        for opts in (specs.PerfOptions(), sp):
            for arch in tconfigs.ARCH_IDS:
                for shape in ("train_4k", "prefill_32k"):
                    if shape in tconfigs.shape_cells(arch):
                        dryrun.run_cell(arch, shape, opts=opts, out_dir=out,
                                        verbose=False)
        rows = dryrun.table(out)
        dryrun.print_table(rows)
    summary["table_rows"] = len(rows)
    return summary


def phase_cells() -> dict:
    """(a) All 33 cells of the dry run on the production grid (one pod of
    16 x 16, and two), built on the meta device: each cell's per-device
    bytes summed from its tensors must equal the count from the config's
    widths; each prints its roofline line.  (b) Yi-6B's decode_32k,
    prefill_32k and train_4k (remat "full", depth cut to fit) as one device
    runs them (``profile_cell``): step ms, peak GB against the analytic peak
    (within PEAK_MARGIN), device busy ms and idle share, the largest
    kernels, beside the analytic bound of the same work; the kernels'
    launches follow the path.  Any failure fails the phase."""
    t0 = time.perf_counter()
    summary = {"cells": 0, "fit": 0, "dominant": {}}
    for multi in (False, True):
        grid = dryrun.production_grid(multi)
        for arch, shape in tconfigs.all_cells():
            cell = specs.build_cell(arch, tconfigs.SHAPES[shape], grid)
            got, want = analysis.per_device_bytes(cell), analysis.device_bytes(cell)
            check(abs(got - want) <= 1e-9 * want,
                  f"{arch} x {shape}: {got} bytes a device, the count {want}")
            roof = analysis.roofline(cell)
            print(analysis.summary(roof), flush=True)
            summary["cells"] += 1
            summary["fit"] += roof.fits
            summary["dominant"][roof.dominant] = summary["dominant"].get(
                roof.dominant, 0) + 1
    check(summary["cells"] == 66, f"{summary['cells']} cells, not 2 x 33")
    summary["build_s"] = time.perf_counter() - t0
    emit({"phase": "cells_meta", **summary})
    emit({"phase": "cells_meta_sp", **cells_sp()})
    counts = {name: 0 for name in COUNTED}
    wants = dict(counts)
    for shape, kw, steps in CELL_RUNS:
        release()
        cell = profile_cell.card_cell("yi_6b", shape, device=DEV, **kw)
        reset_counters()
        out = profile_cell.profile(cell, steps=steps)
        runs = steps + 2                     # a warm-up and a profiled step
        got, want = counts_now(), cell_launches(cell, runs)
        check(got == want, f"{shape}: launches {got}, the path implies {want}")
        for name in COUNTED:
            counts[name] += got[name]
            wants[name] += want[name]
        off = abs(out["peak_gb"] - out["analytic_peak_gb"]) / out["analytic_peak_gb"]
        check(off <= PEAK_MARGIN,
              f"{shape}: peak {out['peak_gb']:.2f} GB, the analytic peak "
              f"{out['analytic_peak_gb']:.2f} GB (margin {PEAK_MARGIN})")
        emit({"phase": "cells_card", **out, "launches": got,
              "peak_off": off, "peak_margin": PEAK_MARGIN})
        del cell
    release()
    return {"cells_yi_6b": (counts, wants)}


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
# A one-step-at-a-time floor, kept beside the byte bound for comparison with
# the first design: it assumed a walk that takes one access at a time, each
# step at least one dependent integer compare and one add, at an assumed 4
# cycles each (not measured here), at the card's maximum SM clock.  The warp
# walk settles 32 accesses a round and is not bound by it; ``bound_ms`` (the
# bytes) is the row's bound.
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
    the kernel's windows of 32, and lengths leave every remainder."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        cap = int(rng.integers(0, 5))
        init = rng.permutation(10)[:int(rng.integers(0, cap + 1))].tolist()
        arr = rng.integers(0, int(rng.integers(1, 7)),
                           size=int(rng.integers(0, 41))).astype(np.int64)
        yield arr, init, cap


def fifo_adversarial():
    """Streams aimed at the warp walk (tests/test_torch_fifo_window.py):
    one vpn 32 times, capacities around the window's width, every length
    mod 32, and two windows that need many rounds: a cold vpn then a sweep
    of the oldest entries of a full TLB (33 rounds), and a window over three
    vpns with peers on every lane (19)."""
    for cap in (0, 1, 2, 31, 32, 33):
        for init in ([], [7], [3, 7, 9][:max(cap, 1)]):
            yield [7] * 37, init, cap
    rng = np.random.default_rng(100)
    for cap in (0, 1, 31, 32, 33):
        for _ in range(12):
            alphabet = int(rng.choice([2, 5, 40, 100, 1000]))
            init = rng.permutation(alphabet + 50)[:int(rng.integers(0, cap + 1))]
            yield (rng.integers(0, alphabet, int(rng.integers(1, 400))),
                   init.tolist(), cap)
    for r in range(32):
        yield rng.integers(0, 60, 96 + r), rng.permutation(60)[:20].tolist(), 24
    init = list(range(1000, 1040))
    yield [init[-1]] * 32 + [5] + init[:31], init, 40
    yield ([0, 2, 2, 0, 2, 1, 0, 2, 1, 0, 0, 1, 2, 0, 1, 1,
            0, 1, 0, 1, 2, 1, 2, 0, 0, 1, 1, 2, 0, 0, 0, 2], [1], 2)


def fifo_long_stream():
    rng = np.random.default_rng(1)
    n, u = FIFO_LONG["n"], FIFO_LONG["distinct"]
    arr = rng.integers(0, u, n)
    arr[:u] = rng.permutation(u)          # every one of the u vpns appears
    rng.shuffle(arr)
    init = rng.permutation(u)[:FIFO_LONG["capacity"]].tolist()
    return (1 << 20) + 7 * arr, [(1 << 20) + 7 * v for v in init], \
        FIFO_LONG["capacity"]


def fifo_rounds(fill0: torch.Tensor, n0: int, ids: torch.Tensor,
                cap: int) -> int:
    """The warp walk's rounds over all its windows on one stream (the
    launch's diagnostic output; the wrapper passes none, so this launch is
    not counted)."""
    U = fill0.numel()
    mask = torch.empty(ids.numel(), dtype=torch.uint8, device=DEV)
    rounds = torch.zeros(1, dtype=torch.int32, device=DEV)
    scratch = (None if U <= fifo_ops._shared_ids(DEV.index)
               else torch.empty(U, dtype=torch.int32, device=DEV))
    code = fifo_ops._launcher()(
        fill0.data_ptr(), U, n0, ids.data_ptr(), ids.numel(), cap,
        None if scratch is None else scratch.data_ptr(), mask.data_ptr(),
        rounds.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("fifo_miss", code)
    return int(rounds.item())


def fifo_check(arr, init, cap) -> dict:
    """Kernel, plain version and numpy loop on one stream, bit for bit: the
    kernel over ``densify``'s ids, and the whole ``"cuda"`` backend call
    through the stream's own ids (``dense``, as the batch engine passes
    them); the seed fill vector stays as it was.  Returns the number of
    flags that differ, the walls of the plain version and of the numpy loop
    on this stream, and the walk's rounds."""
    arr = np.asarray(arr, np.int64)
    fill0, n0, ids = densify(arr, init, cap)
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    got = fifo_miss_ids(f, n0, i, cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fifo_miss_ref(f, n0, i, cap)
    t1 = time.perf_counter()
    loop = fifo_miss(arr, init, cap, backend="numpy")
    t2 = time.perf_counter()
    dense = fifo_miss(arr, init, cap, backend="cuda",
                      dense=np.unique(arr, return_inverse=True))
    err = max(int((got != want).sum()), int((got.cpu().numpy() != loop).sum()),
              int((dense != loop).sum()))
    check(err == 0 and got.shape == (len(arr),) and got.dtype == torch.bool
          and dense.shape == (len(arr),) and dense.dtype == bool,
          f"fifo_miss: {err} flags differ (n {len(arr)}, U {fill0.size}, "
          f"capacity {cap})")
    check(np.array_equal(f.cpu().numpy(), fill0), "fifo_miss wrote its seed")
    rounds = fifo_rounds(f, n0, i, cap) if len(arr) else 0
    windows = -(-len(arr) // 32)
    check(windows <= rounds <= 33 * windows,
          f"fifo_miss: {rounds} rounds over {windows} windows")
    return {"max_abs_err": err, "plain_wall_ms": 1e3 * (t1 - t0),
            "numpy_wall_ms": 1e3 * (t2 - t1), "misses": int(loop.sum()),
            "windows": windows, "rounds": rounds}


def fifo_times(arr, init, cap, sm_mhz: float, iters: int) -> dict:
    """The kernel's device time, the whole ``"cuda"`` backend call's wall
    as the batch engine makes it (its ids given, staging and both copies
    included) and without them (``np.unique`` inside), the byte bound and
    the one-step-at-a-time floor at one stream."""
    arr = np.asarray(arr, np.int64)
    fill0, n0, ids = densify(arr, init, cap)
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    n, U = ids.size, fill0.size
    dense = np.unique(arr, return_inverse=True)
    walls = {"dense": [], "arr_only": []}
    for _ in range(max(iters // 2, 1)):
        for kind, kw in (("dense", {"dense": dense}), ("arr_only", {})):
            t0 = time.perf_counter()
            fifo_miss(arr, init, cap, backend="cuda", **kw)
            walls[kind].append(time.perf_counter() - t0)
    # each input read once (ids and the seed), each flag written once
    t_bytes = (4 * n + 4 * U + n) / HBM_BPS
    return {"n": n, "distinct_ids": U, "capacity": cap, "tlb_entries": n0,
            "fill_vector": ("shared" if U <= fifo_ops._shared_ids(DEV.index)
                            else "global"),
            "ms": time_ms(lambda: fifo_miss_ids(f, n0, i, cap), iters=iters),
            "backend_wall_ms": 1e3 * float(np.median(walls["dense"])),
            "backend_wall_ms_arr_only": 1e3 * float(np.median(walls["arr_only"])),
            "bound_ms": 1e3 * t_bytes, "bound_by": "bytes",
            "chain_floor_ms": n * CHAIN_CYCLES / (sm_mhz * 1e3),
            "bound_used": "bytes (bound_ms); chain_floor_ms, a one-step-at-a-"
                          "time floor, beside it"}


def fifo_rejections() -> dict:
    """Arguments the kernel cannot take fail: the launch refuses a fill
    vector too large for shared memory without a scratch, and ids that are
    not 4-byte aligned, with cudaErrorInvalidValue; an id outside the fill
    vector fails the device assert before the walk (in a process of its
    own: the error ends its CUDA context)."""
    f = torch.zeros(60_000, dtype=torch.int32, device=DEV)
    ids = torch.zeros(8, dtype=torch.int32, device=DEV)
    mask = torch.empty(8, dtype=torch.uint8, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    launch = fifo_ops._launcher()
    too_big = launch(f.data_ptr(), 60_000, 0, ids.data_ptr(), 4, 1, None,
                     mask.data_ptr(), None, stream)
    misaligned = launch(f.data_ptr(), 16, 0, ids.data_ptr() + 2, 4, 1, None,
                        mask.data_ptr(), None, stream)
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
    trials = (list(fifo_trials()) + list(fifo_repeats())
              + list(fifo_adversarial()))
    checked = [fifo_check(*case) for case in trials]
    adversarial = checked[-2:]
    check([c["rounds"] for c in adversarial] == [2 + 33, 19],
          f"fifo_miss: the constructed windows took "
          f"{[c['rounds'] for c in adversarial]} rounds, not [2 + 33, 19]")
    engine_checked = [fifo_check(*case) for case in recorded]
    engine = max(recorded, key=lambda c: np.unique(c[0]).size + len(c[1]))
    engine_walls = fifo_check(*engine)
    long = fifo_long_stream()
    long_walls = fifo_check(*long)
    err = max(c["max_abs_err"] for c in
              checked + engine_checked + [engine_walls, long_walls])
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
    want = uncapped({"paged_attention": 0, "flash_attention": 0,
                     "flash_attention_bwd": 0, "pte_gather": 0,
                     "fifo_miss": launched})
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
           "cases": len(trials) + len(recorded) + 2, "tolerance": 0,
           "engine_calls_rounds_per_window": sum(
               c["rounds"] for c in engine_checked) / max(
               sum(c["windows"] for c in engine_checked), 1),
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
                    default="kernels,serve,parity,coherence,train,cap,cells,"
                            "multipod,model_axis,numa_sim")
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

    rows = []
    if "kernels" in phases:
        rows = phase_kernels()
    elif "kernels_bwd" in phases:         # K2's backward row alone
        rows = [phase_kernels_bwd()]
    elif "kernels_cap" in phases:         # the soft-cap rows alone
        rows = phase_kernels_cap()
    elif "kernels_mla" in phases:         # K4's row alone
        rows = [phase_kernels_mla()]
    runs, walls = {}, {"kernels": time.perf_counter() - t0}

    def timed_phase(name, fn):
        t_start = time.perf_counter()
        out = fn()
        walls[name] = time.perf_counter() - t_start
        return out

    if "serve" in phases:
        runs = timed_phase("serve", lambda: dict(
            {arch: phase_serve(arch, n) for arch, n in depth.items()},
            whisper_base=phase_whisper()))
    elif "serve_mla" in phases:           # Moonlight's serve alone
        runs = timed_phase("serve_mla", lambda: {
            "moonlight_16b_a3b": phase_serve("moonlight_16b_a3b")})
    if "parity" in phases:
        timed_phase("parity", lambda: [phase_parity(arch) for arch in PARITY])
    if "coherence" in phases:
        timed_phase("coherence", phase_coherence)
    if "train" in phases:
        runs.update(timed_phase("train", phase_train))
    if "cap" in phases:
        runs.update(timed_phase("cap", phase_cap))
    if "cells" in phases:
        runs.update(timed_phase("cells", phase_cells))
    if "multipod" in phases:
        runs.update(timed_phase("multipod", phase_multipod))
    if "model_axis" in phases:
        runs.update(timed_phase("model_axis", phase_model_axis))
    elif "model_axis_options" in phases:      # part F alone
        runs.update(timed_phase("model_axis_options", model_axis_options))
    if "numa_sim" in phases:
        fifo_row, *runs["numa_sim"] = timed_phase("numa_sim", phase_numa_sim)
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
            row["launches_by_arch"] = {a: c[row["name"]]
                                       for a, c in counts.items()}
            row["launches"] = sum(row["launches_by_arch"].values())
    if "profile" in phases:
        for i, arch in enumerate(("qwen3_14b", "gemma3_4b",
                                  "qwen3_moe_235b_a22b", "mamba2_370m",
                                  "recurrentgemma_2b")):
            phase_profile(arch, depth[arch], walks=i == 0)
    if "profile" in phases or "profile_train" in phases:
        phase_profile_train()
    emit({"phase": "walls", "wall_s": walls,
          "total_s": time.perf_counter() - t0})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
