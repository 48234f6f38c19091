"""Phase ``kernels_cap`` (also run by ``kernels``): K1, K2 and K2's
backward with the logit soft-cap (cap 50, Gemma 2's published value, and 2,
where the plain version without the cap must miss the bound) against their
plain versions with it, both dtypes, also at the capped serve's Gemma-3-4B
shapes (K1, K2 global and windowed, bf16, where the cap of 2 must be seen
too), the LSEs of the capped scores, timed at Qwen3-14B's serving and
prefill shapes and Yi-6B's training shape beside the uncapped instance and
flex_attention with a tanh score_mod.
"""
import time

import numpy as np
import torch

from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref, ops as flash_ops)
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
from .common import (BWD_TOL_REL, check, DEV, flash_bound, flash_bwd_bound,
                     flash_bwd_case, flash_bwd_rel, FLASH_BWD_TRAIN, flash_case,
                     lse_cases, LSE_TOL, max_err, paged_bound, paged_case, release,
                     SOFTCAP, time_ms, TOL)


# the checks also run at a cap that bites at these inputs (unit normals:
# scaled scores of a few units), where the plain version without the cap must
# miss the bound, or the bound could not see a dropped cap
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


def phase_kernels_cap() -> list:
    """The three capped rows (the module's docstring)."""
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
                a, kw, lse_err = flash_bwd_case(*shape, dt, dout_bf16=dout_bf16,
                                                softcap=cap)
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
    args, kw, _ = flash_bwd_case(*FLASH_BWD_TRAIN, bf16, dout_bf16=True,
                                 softcap=SOFTCAP)
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
