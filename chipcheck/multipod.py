"""Phase ``multipod``: the pod axis on one card (``LoopPods(4)``), Qwen3-14B
and Yi-6B at published widths.  A: ``serve()`` of Qwen3-14B (all 40
layers, batch 16, prompt 1 024, 64 tokens, 32 requests) over 4 KV pools
without device replicas (host mode ``local``) and with them, kept by the
``eager`` and the ``numapte`` prologue (``build_serve_step``), every
replica checked against the host after every step, and one-pool: the
tokens of all four equal; the prologue's device ms and collective bytes a
step, its K3 launches.  B: sequence-parallel decode of one 32 768-token
context over 4 shards (all 40 layers, 32 steps, through
``build_serve_step(sp=True)``) against the one-pool decode of the same
state, a token flipping only at a near-tie and in at most 4 steps; K1 with
the LSE at the shard shape and the combine, timed beside the one-launch K1.
C: Yi-6B (2 of 32 layers, batch 8 x 1 024 over 4 pods) trained one step
with the int8 error-feedback pod leg; its averaged gradients (first and
second step) against an independent int8 mean of the pods' own gradients
within 1 ulp, a dropped pod's term caught, the int8 average within half a
scale step of the float32 one.
"""
import dataclasses

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import compression, LoopPods
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
from repro_torch.kvcache import gather as kv_gather
from repro_torch.launch import specs
from repro_torch.launch.serve import serve
from repro_torch.models import decode_step, greedy_sample, init_params
from repro_torch.optim import adamw_init, adamw_update
from .common import (check, counts_now, DEV, emit, expected_launches,
                     lse_pointers_counted, max_err, paged_case, paged_library,
                     paged_lse, paged_lse_bound, randn, release, reset_counters, SP,
                     sp_context, SP_SHARD, time_ms, timed, TOL, uncapped)


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
    """B: one context prefilled and moved into SP's layout
    (``sp_context``); decode SP over LoopPods(4), then the one-pool decode
    fed the same tokens."""
    cfg = get_config("qwen3_14b")
    bt, n, steps = cfg.kv_block_tokens, SP["shards"], SP["steps"]
    release()
    torch.cuda.reset_peak_memory_stats()
    kv, phys, one, logits, sp, local = sp_context(cfg, params)
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
