"""Phases ``serve``, ``serve_mla``, ``parity`` and ``coherence``.

serve: each arch at its published widths served through the numaPTE
paged-KV path (random weights from a seed): Qwen3-14B (global layers, depth
``--layers``), Gemma-3-4B (all 34 layers: 29 local layers decode from ring
caches, 5 global layers through the block table), the mixture-of-experts
configs Qwen3-235B-A22B (8 of 94 layers) and Kimi-K2 (2 of 61: its dense
first layer and one MoE layer), Nemotron-4-15B (all 32), Chameleon-34B (24
of 48), Yi-6B (all 32), Mamba-2-370M (all 48 SSD layers: no attention, the
block table is walked all the same) and RecurrentGemma-2B (all 26: 18
RG-LRU layers, 8 local attention layers on rings), Moonlight-16B-A3B (all
27: latent attention decoding on K4, dropless sigmoid-routed experts;
``serve_mla`` serves it alone), then Whisper-base (all 12 layers) through
``whisper_serve``: ``prefill_encdec`` and ``decode_step`` over the
manager's tables.  The launch counters of the kernels are zeroed before
each and read after, and must equal what the arch's layer groups imply
(zero for a kernel it has no layer for, and for K2's backward); no serving
launch writes an LSE.

parity: the same widths at a cut depth, per arch: kernel path against plain
path (bf16 logits, float32 token ids where the weights fit in float32, and
for the MoE configs the share of expert ids that agree), and the three
coherence modes against each other; Mamba-2, whose model path runs no
kernel, instead holds prefill + one decode step against forward_lm in
float32 at a ragged prompt.

coherence: the port's serving_coherence benchmark (three modes of Qwen3-14B
at published widths, 4 layers, and the budget row).
"""
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import (active_param_count, decode_step, forward_lm,
                                init_decode_state, init_params, layer_groups,
                                param_count, prefill)
from .common import (attention_layers, check, counts_now, DEV, emit, expected_launches,
                     first_wave, lse_pointers_counted, plain_versions, rel_err, release,
                     reset_counters, route_agreement, routes_recorded, WHISPER,
                     whisper_serve)


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
