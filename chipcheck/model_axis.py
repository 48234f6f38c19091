"""Phase ``model_axis``, parts A-E (part F is ``model_axis_options``): the
in-pod model axis (tensor parallelism, ``LoopPods`` on one card; the
kernels phase holds K1 on a shard's kv heads of the replicated slab, K2 and
its backward at the shard shapes).  A: ``serve()`` of Qwen3-14B (all 40
layers, published widths, the serve phase's traffic, one pod) at model = 1
and at model = 2 from the same seeded weights: the first decode step's
logits within 0.03, tokens equal but for first flips at near-ties (in at
most MAX_FLIP_SHARE of the compared decisions), K1 and K2 once a shard a
layer, K3 as at model = 1; prefill / step ms, tokens/s, peak GB, the model
axis's bytes a step.  B: Yi-6B (8 of 32 layers, batch 8 x 1 024, float32
master weights) 4 steps at model = 2 against model = 1.  C: Yi-6B (2 of 32
layers) 6 steps at (data 2, model 4), a checkpoint equal to the gathered
live shards, 4 more steps there and 4 restored onto (data 2, model 2):
within 2e-2 and the bound from readings.  D: the other families served at
model = 2 against model = 1.  E: Megatron sequence parallelism at model 2,
the dry run's cells on the card: Yi-6B (8 of 32 layers, 8 x 1 024) 4 train
steps and Qwen3-14B's prefill (8 of 40 layers, 16 x 1 024) with and without
it: the first loss bit-equal and the rest within SP_LOSS_TOL, the prefill's
logits and tokens equal, each step's launches as the path implies and its
model-axis bytes equal to ``analysis.model_wire`` of its cell, and at 2
layers the first gradients equal but for the norm scales' (within
SP_GRAD_TOL_REL).
"""
import dataclasses
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch._tree import tree_leaves_with_path, tree_map
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import analysis, specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import init_params, layer_groups
from repro_torch.models.common import SHAPES_ONLY
from repro_torch.models.transformer import gather_vocab
from repro_torch.optim import adamw_init
from .common import (check, counts_now, DEV, ELASTIC_LOSS_TOL, emit, expected_launches,
                     FAMILIES, first_flips, heads_shards, held_to_model_one,
                     lse_pointers_counted, MODEL_SERVE, MODEL_TRAIN_LOSS_TOL, release,
                     reset_counters, route_agreement, routes_recorded, SERVE_KEEP,
                     shard_in_place, uncapped, WHISPER, whisper_serve)


# B: Yi-6B at the train phase's cut (8 of 32 layers, batch 8 x 1 024),
# 4 steps at model = 2 against model = 1
MODEL_TRAIN = dict(arch="yi_6b", n_layers=8, batch=8, seq=1024, steps=4,
                   model=2, loss_tol=MODEL_TRAIN_LOSS_TOL)
# C: Yi-6B (2 of 32 layers): 6 steps at (data 2, model 4), a checkpoint,
# 4 more there and 4 restored onto (data 2, model 2)
ELASTIC = dict(arch="yi_6b", n_layers=2, batch=8, seq=1024, first=6, then=4,
               grid_a=(2, 4), grid_b=(2, 2), ref_tol=2e-2,
               loss_tol=ELASTIC_LOSS_TOL)


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


def loose_to_model_one(one, two) -> dict:
    """The same readings as ``held_to_model_one``, unchecked."""
    first_err = float(np.abs(two["first_logits"] - one["first_logits"]).max())
    return {"first_step_logits_rel_err":
            first_err / float(np.abs(one["first_logits"]).max()),
            "rows_token_equal": int((one["token_ids"] == two["token_ids"])
                                    .all(axis=1).sum())}


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


def phase_model_axis() -> dict:
    runs = model_axis_serve()
    runs.update(model_axis_train())
    runs.update(model_axis_elastic())
    runs.update(model_axis_families())
    runs.update(model_axis_sp())


    return runs
