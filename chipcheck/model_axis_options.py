"""Phase ``model_axis_options``, the model axis's part F (slice 16.1c; the
``model_axis`` phase runs it after parts A-E): F1 part A over 4 KV pools on
4 pods (the model axis's bytes a step equal to ``analysis.model_wire``); F2
part B's 32 768-token context decoded SP over 4 pools at model 2 (each
shard's heads, K1 with kv_heads and the LSE), held to model 1's SP decode
(0.03) and to the one-pool decode (SP2_REL, at most SP["max_flips"] flips at
near-ties); F3 data 2 x model 2 beside data 1 x model 2 (Gemma-3-4B,
RecurrentGemma-2B, Mamba-2 in float32, Whisper-base; part D's bounds,
bit-equality read); F4 the families' train cells at model 2 beside model 1
(FAMILY_TRAIN: losses within MODEL_TRAIN_LOSS_TOL, step ms, peak GB, K2 /
K2-backward launches; the MoE config follows model 1's expert ids).
"""
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch._tree import tree_map
from repro_torch.configs import get_config
from repro_torch.distributed import LoopPods
from repro_torch.kvcache import gather as kv_gather
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import serve
from repro_torch.models import (decode_step, greedy_sample, init_decode_state,
                                init_params, layer_groups)
from repro_torch.models.transformer import gather_vocab
from .common import (attention_layers, check, counts_now, DEV, emit, expected_launches,
                     FAMILIES, heads_shards, held_to_model_one, max_err, MODEL_SERVE,
                     MODEL_TRAIN_LOSS_TOL, POOLS, randn, release, reset_counters,
                     route_agreement, routes_recorded, SERVE_KEEP, shard_in_place, SP,
                     sp_context, time_ms, TOL, uncapped, WHISPER, whisper_serve)
from .model_axis import model_axis_serve


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
    release()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                         param_dtype=cfg.dtype)
    torch.cuda.reset_peak_memory_stats()
    kv, phys, one, logits, moved, local = sp_context(cfg, params)
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
