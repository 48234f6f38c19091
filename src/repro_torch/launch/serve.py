"""Serving loop: batched decode over the numaPTE paged-KV substrate.

Runs a real request loop: sequences arrive in waves, prefill, decode in
lockstep batches, finish and free — every mutation flowing through the
HostBlockManager so the run reports exact coherence/shootdown counters for
each policy.  Runs on the GPU unless ``device="cpu"`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \
        --full-width --requests 32 --batch 16 --prompt-len 1024 --gen-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_4b \
        --full-width --requests 32 --batch 16 --prompt-len 2048 --gen-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b --mode eager

Over the pod axis: ``--pools 4`` partitions the KV slabs into one pool a pod
(each row homed on its pool's pod), and ``--replicas`` keeps per-pod device
replicas of the block table, maintained each step by the coherence prologue
of ``--mode`` (eager or numapte; ``launch/specs.py:build_serve_step`` on
``LoopPods``: one process, one card):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \
        --full-width --requests 32 --batch 16 --prompt-len 1024 --gen-len 64 \
        --pools 4 --mode numapte --replicas

Over the in-pod grid: ``--model 2`` splits the weights over two
tensor-parallel shards as the config's rules place them (``LoopPods(2)`` on
one card: whole heads a shard, with one flash and one paged-attention
launch a shard a layer where the heads split; the FFN by ``ff``, the MoE
experts by expert, the SSD by head and the RG-LRU by channel; vocab-parallel
embedding and head), and ``--data 2`` serves each wave's rows as two data
shards; every decoder-only config:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \
        --full-width --requests 32 --batch 16 --prompt-len 1024 --gen-len 64 \
        --pods 1 --model 2

An encoder-decoder config (whisper_base) raises here, as the reference's
serve() cannot run it either: drive ``prefill_encdec`` + ``decode_step``.
A mixture-of-experts config does not fit one card at its published depth;
``--layers`` cuts the depth and keeps every width:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3_moe_235b_a22b --full-width --layers 8 \
        --requests 32 --batch 16 --prompt-len 1024 --gen-len 64
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch kimi_k2_1t_a32b --full-width --layers 2 \
        --requests 32 --batch 16 --prompt-len 1024 --gen-len 64
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..kernels.pte_gather.ops import pte_gather
from ..kvcache import PagedKVManager
from ..kvcache.gather import pool_of_rows
from ..models import ModelConfig, init_decode_state, init_params, prefill
from ..models.transformer import gather_vocab, vocab_split
from ..pagedpt.blocktable import (CoherenceMode, eager_sync_bytes,
                                  numapte_fetch_bytes)
from .mesh import make_debug_mesh
from .specs import (build_serve_step, coherence_rounds, grid_sampler,
                    kv_split, make_rules, prefill_on_grid, shard_params,
                    split_leaves, state_split, elapsed_ms)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kv_layout(state) -> str:
    """How the model axis holds the attention caches (the state's
    ``layout``): "split" by kv head, "replicated", or "none" (no attention
    layer)."""
    if not any(name in cache for cache in state.caches
               for name in ("k_slabs", "ring_k")):
        return "none"
    return "split" if state.layout.split else "replicated"


@torch.no_grad()
def serve(arch: str, *, n_requests: int = 16, prompt_len: int = 32,
          gen_len: int = 16, batch: int = 4, n_pods: int = 4,
          mode: str = "numapte", seed: int = 0, verbose: bool = True,
          device: DeviceLike = None, full_width: bool = False,
          n_layers: Optional[int] = None, cfg: Optional[ModelConfig] = None,
          params=None, n_pools: int = 1, replicas: bool = False,
          check_replicas: bool = False, data: int = 1, model: int = 1,
          trace_logits: int = 0):
    """Serve ``n_requests`` random prompts in waves of ``batch``.

    ``full_width`` runs the published config instead of the smoke config;
    ``n_layers`` cuts its depth only (never a width).  ``cfg`` / ``params``
    override the config and the seeded random weights.  Besides the
    counters the result holds ``prefill_ms`` and ``decode_step_ms``: the mean
    synchronised time of a wave's prefill and of one of its decode steps,
    host protocol and page walk included.  Random weights are
    stored in the config's working dtype at full width (a 14.8 B-parameter
    model does not fit in float32 beside its KV slabs) and in
    ``cfg.param_dtype`` otherwise.

    ``n_pools`` > 1 partitions the KV slabs into pools (it must equal
    ``n_pods``): row b of a wave lives in pool ``b // (batch / n_pools)``
    and its sequence is homed on that pod.  ``replicas`` keeps the per-pod
    device replicas of the block table and runs ``mode``'s coherence
    prologue (eager or numapte) in every decode step (``build_serve_step``
    over ``LoopPods(n_pods)``), fed by the manager's drained mutations and
    miss buffers; a step whose buffers outgrow the budgets runs extra
    prologue rounds.  The result then adds the prologue's time a step
    (``prologue_ms``: CUDA events around each prologue on the card, the
    host clock on the CPU), its collective bytes (``wire_bytes_per_step``,
    beside the budget model's ``eager_sync_bytes`` / ``numapte_fetch_bytes``),
    its K3 launches a step, and with ``check_replicas`` the count of replica
    entries that differed from the host's table after a step (eager: every
    entry; numapte: where ``host.present`` holds one).

    ``data`` and ``model`` build the grid's in-pod axes (``LoopPods`` on
    this device): each wave's rows split over ``data`` shards (each shard's
    rows of the rings, recurrent states and pools its own), and the
    weights over ``model`` tensor-parallel shards (``params`` may come whole
    or already split by ``shard_params``); the KV slabs (pooled or not) and
    rings follow the rules table (every config's own keeps them replicated
    over ``model``), the recurrent states the split of their layers, and
    the model axis's collective bytes a decode step come back as
    ``model_wire_bytes_per_step``.  ``trace_logits`` = k > 0 adds the first
    decode step's logits of the first wave (``first_logits`` [batch, V]
    float32) and every step's k largest logits and their ids
    (``top_values`` / ``top_ids`` [n_requests, gen_len, k]), gathered over
    the model axis: the checks against another grid read them."""
    device = resolve_device(device)
    if n_pools > 1 and n_pools != n_pods:
        raise ValueError(f"{n_pools} pools need as many pods, not {n_pods}")
    if replicas and mode == CoherenceMode.LOCAL.value:
        raise ValueError("device replicas need a coherence mode, eager or "
                         "numapte, not local")
    if cfg is None:
        cfg = get_config(arch) if full_width else get_smoke_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    grid = make_debug_mesh(n_pods if replicas else 1, data=data, model=model,
                           device=device)
    if cfg.family == "encdec":
        # the reference's serve() calls prefill(), which reads the decoder-only
        # embedding an encoder-decoder lacks (ROADMAP queue 3)
        raise ValueError(
            f"{arch}: serve() drives decoder-only configs; an encoder-decoder "
            "is served through prefill_encdec + decode_step over a "
            "PagedKVManager's tables (ROADMAP queue 3: the reference's serve() "
            "raises KeyError 'embedding' for it)")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(
            cfg, gen, param_dtype=cfg.dtype if full_width else cfg.param_dtype)
    if model > 1 and not any(split_leaves(params)):
        params = shard_params(params, grid, cfg)
    tp = grid.model if model > 1 else None
    bt = cfg.kv_block_tokens
    max_blocks = -(-(prompt_len + gen_len) // bt) + 1
    n_frames = batch * max_blocks * 4
    kv = PagedKVManager(n_frames=n_frames, block_tokens=bt,
                        max_blocks_per_seq=max_blocks, n_pods=n_pods,
                        mode=CoherenceMode(mode), n_pools=n_pools,
                        replicas=replicas, device=device)
    state = init_decode_state(cfg, batch, n_frames, max_blocks,
                              n_pools=n_pools, device=device,
                              kv_split=kv_split(cfg, grid, make_rules(cfg, grid)),
                              state_split=state_split(params, grid))
    home = (pool_of_rows(batch, n_pools).tolist() if n_pools > 1
            else [i % n_pods for i in range(batch)])
    pods = grid if replicas else None
    coherence = mode if replicas else "none"
    timings: list = []
    finite = torch.ones((), dtype=torch.bool, device=device)
    greedy = grid_sampler(params, grid)
    traced: list = []            # per step: (top values, top ids) [batch, k]
    first_logits = None

    def sample(logits: torch.Tensor) -> torch.Tensor:
        nonlocal first_logits
        # the trace's gather is the harness's, not the step's: its
        # bytes leave the model axis's counters as they were
        counted = (grid.model.wire_bytes, dict(grid.model.calls))
        whole = (gather_vocab(logits, tp) if tp is not None
                 and vocab_split(params) else logits).float()
        grid.model.wire_bytes, grid.model.calls = counted
        if first_logits is None:
            first_logits = whole.cpu().numpy()
        top = whole.topk(trace_logits, dim=-1)
        traced.append((top.values, top.indices))
        return greedy(logits)

    # the default sampler lets the card replay the step as a CUDA graph
    step = build_serve_step(cfg, coherence=coherence, pods=grid,
                            sample=sample if trace_logits else None,
                            prologue_timer=timings)
    k3_prologue = 0
    mismatches = 0

    def extra_rounds() -> int:
        """Prologue rounds for what one step's budgets left queued, then
        the replica check."""
        nonlocal mismatches
        launched = coherence_rounds(coherence, pods, kv, timings)
        if check_replicas:
            mismatches += kv.replica_mismatches(full=coherence == "eager")
        return launched

    # run prefill and decode once before the timer starts, so that building
    # the kernels, warming the GEMM library and capturing the step's graph
    # never land inside the tok_per_s window; their outputs are discarded.
    # All-(-1) tables keep them out of the paged slabs, but they do write the
    # local layers' rings, which every wave's prefill rebuilds from zeros
    warm_phys = torch.full((batch, max_blocks), -1, dtype=torch.int32,
                           device=device)
    warm_prompts = torch.zeros((batch, prompt_len), dtype=torch.int32,
                               device=device)
    on_grid = data > 1 or model > 1

    def run_prefill(prompts, st, phys):
        if on_grid:
            return prefill_on_grid(cfg, params, prompts, st, phys, grid)
        return prefill(cfg, params, prompts, st, phys)

    run_prefill(warm_prompts, state, warm_phys)
    warm_tokens = torch.zeros((batch,), dtype=torch.int32, device=device)
    step(params, state, warm_tokens, warm_phys)
    traced.clear()
    first_logits = None
    _sync(device)
    grid.model.reset_counters()

    done_tokens = 0
    model_step_bytes = 0
    sampled = []                  # per wave: (n_live, [gen_len] of [batch])
    prefill_s = decode_s = 0.0
    n_waves = 0
    t0 = time.perf_counter()
    seq_id = 0
    rng = np.random.default_rng(seed)
    while seq_id < n_requests:
        wave = list(range(seq_id, min(seq_id + batch, n_requests)))
        seq_id += len(wave)
        # pad the wave to the fixed batch with inactive rows (-1 tables):
        # their device writes are masked off, so a partial final wave can
        # neither decode into a live sequence's KV frames nor double-count
        # record_access on its blocks
        active = wave + [-1] * (batch - len(wave))
        n_live = len(wave)
        for i, sid in enumerate(wave):
            kv.start_sequence(sid, prompt_len, pod=home[i])
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len))
        ).to(device=device, dtype=torch.int32)
        # pod=None: each row walks through its home pod, and the scheduler's
        # pod commits tails through its own replica (cross-pod fetches)
        t_wave = time.perf_counter()
        phys = kv.physical_tables(active)
        _, st = run_prefill(prompts, state, phys)
        _sync(device)
        t_prefilled = time.perf_counter()
        tokens = torch.zeros((batch,), dtype=torch.int32, device=device)
        steps = []
        for t in range(gen_len):
            for i, sid in enumerate(wave):
                kv.maybe_extend(sid, prompt_len + t + 1)
            phys = kv.physical_tables(active, record=(t % 4 == 0))
            model_before = grid.model.wire_bytes
            if pods is None:
                tokens, st = step(params, st, tokens, phys)
            else:
                before = pte_gather.launches
                tokens, st, _ = step(params, st, tokens, phys, kv.replicas,
                                     *kv.coherence_inputs())
                k3_prologue += pte_gather.launches - before + extra_rounds()
            finite &= torch.isfinite(
                step.last["logits"][..., :n_live, :]).all()
            model_step_bytes += grid.model.wire_bytes - model_before
            steps.append(tokens)
            done_tokens += len(wave)
        _sync(device)
        prefill_s += t_prefilled - t_wave
        decode_s += time.perf_counter() - t_prefilled
        n_waves += 1
        sampled.append((len(wave), steps))
        for sid in wave:
            kv.finish_sequence(sid)      # munmap analogue -> invalidations
        kv.host.check_invariants()
        kv.check_device_table()
    _sync(device)
    dt = time.perf_counter() - t0
    if pods is not None:            # deliver the last frees, and check
        k3_prologue += extra_rounds()
    c = kv.host.counters
    token_ids = np.concatenate(
        [torch.stack(steps, dim=1)[:n_live].cpu().numpy()
         for n_live, steps in sampled]) if sampled else np.zeros((0, gen_len))
    result = {
        "mode": mode, "n_pods": n_pods, "tokens": done_tokens,
        "tok_per_s": done_tokens / dt,
        "invalidations_sent": c.invalidations_sent,
        "invalidations_filtered": c.invalidations_filtered,
        "coherence_bytes": c.coherence_bytes,
        "fetches": c.fetches, "prefetched": c.prefetched,
        "table_pages": kv.footprint_pages(),
        # additions of the port: what ran, and what it produced
        "device": str(device), "n_layers": cfg.n_layers,
        "prefill_ms": 1e3 * prefill_s / max(n_waves, 1),
        "decode_step_ms": 1e3 * decode_s / max(n_waves * gen_len, 1),
        "logits_finite": bool(finite),
        "token_ids": token_ids,          # [n_requests, gen_len]
    }
    if n_pools > 1 or pods is not None:
        result.update(n_pools=n_pools, replicas=replicas)
    if data > 1 or model > 1:
        result.update(
            data=data, model=model,
            model_wire_bytes_per_step=model_step_bytes / max(
                n_waves * gen_len, 1),
            model_wire_bytes=grid.model.wire_bytes,
            model_calls=dict(grid.model.calls),
            kv_layout=_kv_layout(state))
    if trace_logits:
        vals = torch.stack([v for v, _ in traced], dim=1).cpu().numpy()
        ids = torch.stack([i for _, i in traced], dim=1).cpu().numpy()
        result.update(first_logits=first_logits,
                      top_values=np.concatenate(
                          [vals[:n, w * gen_len:(w + 1) * gen_len]
                           for w, (n, _) in enumerate(sampled)]),
                      top_ids=np.concatenate(
                          [ids[:n, w * gen_len:(w + 1) * gen_len]
                           for w, (n, _) in enumerate(sampled)]))
    if pods is not None:
        n_steps = max(n_waves * gen_len, 1)
        _sync(device)
        result.update({
            "prologue_ms": sum(map(elapsed_ms, timings)) / n_steps,
            "prologue_calls": len(timings),
            "wire_bytes_per_step": pods.wire_bytes / n_steps,
            "eager_sync_bytes": eager_sync_bytes(kv.spec),
            "numapte_fetch_bytes": numapte_fetch_bytes(kv.spec),
            "prologue_k3_launches": k3_prologue,
            "replica_mismatches": mismatches if check_replicas else None})
    if verbose:
        print({k: (round(v, 1) if isinstance(v, float) else v)
               for k, v in result.items()
               if k not in ("token_ids", "first_logits", "top_values",
                            "top_ids")})
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_14b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pods", type=int, default=4)
    ap.add_argument("--mode", choices=[m.value for m in CoherenceMode],
                    default="numapte")
    ap.add_argument("--pools", type=int, default=1,
                    help="KV pools (one a pod when > 1)")
    ap.add_argument("--replicas", action="store_true",
                    help="per-pod device replicas of the block table, kept "
                         "by --mode's coherence prologue")
    ap.add_argument("--full-width", action="store_true",
                    help="the published config instead of the smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (widths stay as published)")
    ap.add_argument("--data", type=int, default=1,
                    help="data shards of the grid (each wave's rows split)")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel shards of the grid's model axis")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args()
    serve(args.arch, n_requests=args.requests, prompt_len=args.prompt_len,
          gen_len=args.gen_len, batch=args.batch, n_pods=args.pods,
          mode=args.mode, device=args.device, full_width=args.full_width,
          n_layers=args.layers, n_pools=args.pools, replicas=args.replicas,
          data=args.data, model=args.model)


if __name__ == "__main__":
    main()
