"""Phases ``train`` and ``cap``.

train: Yi-6B trained at published widths, 8 of its 32 layers (TRAIN), batch
8 x seq 1 024, 6 steps of lm_loss -> backward -> AdamW from seed 0, twice:
the loss lists must be bit-equal, and K2's forward and backward must run
once a layer a step (K1 and K3 never); step time, tokens/s, peak memory.
Then one step at 2 layers, kernel path against plain path (loss rel <=
1e-3, every gradient leaf within 2e-2 of its largest value), and the
fault-tolerant Trainer at the smoke width (12 steps, a checkpoint every 4,
a crash at 6) whose replay must match a clean run; these take no
rematerialisation (remat=False, as the reference's Trainer).  The remat
row: the same cut's gradients with remat False, "full" and "dots" in turn
on the same weights, 3 rounds (each one AdamW step): losses and the first
round's gradients bit-equal across the three, K2's forward and LSE writes
doubled under remat; gradient ms, AdamW ms, peak GB; then the most layers
whose step trains on the card with remat "full".

cap: the logit soft-cap at published widths: Gemma-3-4B served (all 34
layers, one wave of 16 x 2 048, 64 tokens) with cap 50 beside without:
every K1 and K2 launch of the capped run is the capped instance and none of
the other's; prefill / step ms, tokens/s; the capped first wave's prefill
and first step against the plain path (logits within 0.03, tokens equal but
at near-ties); one Yi-6B train step (8 of 32 layers, 8 x 1 024) with the cap
against the plain path (loss 1e-3, every gradient leaf 2e-2).
"""
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.launch import analysis, profile_cell, specs
from repro_torch.launch.serve import serve
from repro_torch.models import init_params, lm_loss
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.runtime import (FailureInjector, train_step, trainable, Trainer,
                                 TrainerConfig)
from .common import (check, COUNTED, counts_now, DEV, emit, expected_launches,
                     first_wave, lse_pointers_counted, plain_versions, rel_err, release,
                     reset_counters, SOFTCAP, uncapped)


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
    """Phase ``train`` (the module's docstring).  Returns the counts of the
    first run and the remat row's, with what the path implies."""
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
