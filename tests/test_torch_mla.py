"""Moonlight-16B-A3B's block: multi-head latent attention (MLA) over the
paged latent cache and sigmoid-routed dropless experts.

On the CPU at the smoke config's size: the port against the benchmark's
plain reference (``perfbench/reference/mla_moe.py``: prefill, then decode
through the pooled latent cache, against the full forward), the routing
and its gates against a hand count, no dropped token under a router that
sends every token to one expert, the plain MLA decode against gather +
softmax, the latent's writes, the spans.  On the card (marker ``card``):
K4 against its plain version, and the served step replayed as a CUDA graph
bit-equal to the eager step.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.reference import mla_moe  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import mla_decode_ref  # noqa: E402
from repro_torch.kvcache.gather import (pooled_tables, scatter_latent,  # noqa: E402
                                        write_latent)
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import init_decode_state, init_params, prefill  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import (decode_step,  # noqa: E402
                                            greedy_sample, param_count)

ARCH = "moonlight_16b_a3b"
SMOKE = get_smoke_config(ARCH)
F32 = dataclasses.replace(SMOKE, dtype=torch.float32, param_dtype=torch.float32)
CPU = torch.device("cpu")
FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
          "d_ff", "vocab_size", "ffn_act", "rope_theta", "tie_embeddings",
          "kv_block_tokens", "n_experts", "experts_per_token", "moe_d_ff",
          "n_shared_experts", "first_dense_layers", "kv_lora_rank",
          "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "moe_router",
          "moe_routed_scale", "moe_dropless", "f32_residual")


def _model(cfg=SMOKE, dtype="float32") -> dict:
    """The benchmark's model dictionary of ``cfg``."""
    return dict({f: getattr(cfg, f) for f in FIELDS}, dtype=dtype,
                router_bias_std=0.05)


def test_config_published_and_registered():
    cfg = get_config(ARCH)
    assert ARCH not in ARCH_IDS and get_config("moonlight-16b-a3b") is cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == \
        (27, 2048, 16, 512, 128, 64, 128)
    assert (cfg.n_experts, cfg.experts_per_token, cfg.moe_d_ff,
            cfg.n_shared_experts, cfg.first_dense_layers, cfg.d_ff) == \
        (64, 6, 1408, 2, 1, 11264)
    assert cfg.mla and cfg.moe_router == "sigmoid" and cfg.moe_dropless
    # 15.96 B parameters, counted on the meta device
    assert param_count(cfg) == pytest.approx(15.96e9, rel=0.005)


@pytest.mark.parametrize("pools", [1, 2])
def test_port_against_reference_prefill_then_decode(pools):
    """Prefill of 2 rows through the (pooled) latent slabs, then 6 decode
    steps through them, against the reference's full forward: logits
    within 1e-4 in float32 at every position the port computes."""
    model = _model()
    w = mla_moe.make_weights(model, 2 ** 31 + 7, CPU)
    params = mla_moe.port_params(model, w)
    B, S, steps = 2, 24, 6
    bt = F32.kv_block_tokens
    mb = -(-(S + steps) // bt) + 1
    state = init_decode_state(F32, B, B * mb, mb, n_pools=pools, device=CPU)
    assert set(state.caches[0]) == {"latent"}
    assert state.caches[0]["latent"].shape[-2:] == (1, 64 + 16)
    if pools > 1:       # frames local to each row's pool
        phys = torch.arange(mb, dtype=torch.int32).repeat(B, 1)
    else:
        phys = torch.arange(B * mb, dtype=torch.int32).view(B, mb)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, F32.vocab_size, (B, S + steps), generator=gen)
    want = mla_moe.logits(model, w, list(toks), [range(S + steps)] * B)
    with torch.no_grad():
        logits, state = prefill(F32, params, toks[:, :S], state, phys)
        got = [logits]
        for t in range(steps):
            logits, state = decode_step(F32, params, state, toks[:, S + t], phys)
            got.append(logits)
    for i, lg in enumerate(got):
        ref = torch.stack([want[b][S - 1 + i] for b in range(B)])
        assert torch.allclose(lg, ref, atol=1e-4, rtol=1e-4), i


def test_reference_fp8_control_differs():
    model = _model()
    w = mla_moe.make_weights(model, 5, CPU)
    toks = [torch.arange(20) % 512]
    exact = mla_moe.logits(model, w, toks, [range(20)])[0]
    low = mla_moe.logits(model, w, toks, [range(20)], fp8=True)[0]
    assert (exact - low).abs().max() > 1e-2


def test_sigmoid_routes_and_gates_by_hand():
    """Top 2 of 4 on sigmoid(logit) + bias, gates the unbiased scores over
    their sum times 2.0; a tie goes to the lower id."""
    cfg = dataclasses.replace(F32, n_experts=4, experts_per_token=2,
                              moe_routed_scale=2.0)
    p = {"router_bias": torch.tensor([0.4, 0.0, 0.0, 0.7])}
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0], [0.0, 0.0, 0.0, 0.0]])
    r = moe.route(cfg, p, None, logits=logits)
    s = [1 / (1 + math.exp(-v)) for v in (0.0, 1.0, 2.0, -1.0)]
    # row 0: s + bias = [0.9, 0.731, 0.881, 0.969]: experts 3 then 0
    assert r.eids[0].tolist() == [3, 0]
    assert r.gates[0].tolist() == pytest.approx(
        [2 * s[3] / (s[3] + s[0]), 2 * s[0] / (s[3] + s[0])])
    # row 1: all equal: experts 0 and 1, gates 1.0 each
    p["router_bias"] = torch.zeros(4)
    r = moe.route(cfg, p, None, logits=logits)
    assert r.eids[1].tolist() == [0, 1]
    assert r.gates[1].tolist() == pytest.approx([1.0, 1.0])
    # the scores themselves: sigmoid of the float32 logits
    assert r.probs[0].tolist() == pytest.approx(s)


def _moe_by_token(cfg, p, x):
    """The experts token by token, each token's chosen experts summed."""
    xf = x.reshape(-1, x.shape[-1])
    r = moe.route(cfg, p, xf)
    out = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for e, g in zip(r.eids[t].tolist(), r.gates[t].tolist()):
            h = xf[t] @ p["we_in"][e]
            y = (torch.nn.functional.silu(xf[t] @ p["we_gate"][e]) * h) @ p["we_out"][e]
            out[t] += g * y
        sh = p["shared"]
        out[t] += ((torch.nn.functional.silu(xf[t] @ sh["w_gate"])
                    * (xf[t] @ sh["w_in"])) @ sh["w_out"])
    return out.reshape(x.shape), r


@pytest.mark.parametrize("shape", [(2, 40), (80, 1)],
                         ids=["prefill_segments", "decode_capacity"])
def test_no_token_dropped_under_one_expert(monkeypatch, shape):
    """A router whose bias sends every token to expert 0 (80 assignments to
    one expert, 10x the mean load): the dropless layer computes every
    assignment, in segments of 32 tokens (prefill) or at capacity = tokens
    (decode); the softmax layer's capacity would drop all but C of them."""
    monkeypatch.setattr(moe, "DROPLESS_CHUNK", 32)
    gen = torch.Generator().manual_seed(1)
    p = moe.init_moe(F32, gen, torch.float32)
    p["router_bias"] = torch.zeros(F32.n_experts)
    p["router_bias"][0] = 100.0
    x = torch.randn(*shape, F32.d_model, generator=gen)
    got, _ = moe.moe_forward(F32, p, x)
    want, r = _moe_by_token(F32, p, x)
    assert (r.eids == 0).any(-1).all()
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-5)
    # the capacity a softmax layer would give these 80 tokens
    C = moe.expert_capacity(80, F32.n_experts, F32.experts_per_token)
    assert C < 80


def test_plain_mla_decode_is_gather_softmax():
    """mla_decode's plain version (the CPU's) against a walk of each row's
    block table by hand: softmax(scale q . latent) . latent[:, :dv], a dead
    row zeros, absent frames skipped."""
    gen = torch.Generator().manual_seed(2)
    B, H, dv, dr, bt, MB, N = 3, 4, 64, 16, 16, 4, 12
    q = torch.randn(B, H, dv + dr, generator=gen)
    slab = torch.randn(N, bt, 1, dv + dr, generator=gen)
    tables = torch.tensor([[3, 7, -1, 1], [0, 2, 4, -1], [-1, -1, -1, -1]],
                          dtype=torch.int32)
    lens = torch.tensor([60, 41, 10], dtype=torch.int32)
    got = paged_ops.mla_decode(q, slab, tables, lens, scale=0.125, dv=dv)
    assert torch.equal(got, mla_decode_ref(q, slab, tables, lens, scale=0.125,
                                           dv=dv))
    for b in range(B):
        rows = [slab[f, s, 0] for c, f in enumerate(tables[b].tolist())
                for s in range(bt) if f >= 0 and c * bt + s < lens[b]]
        if not rows:
            assert torch.equal(got[b], torch.zeros(H, dv))
            continue
        lat = torch.stack(rows)
        p = torch.softmax(q[b] @ lat.T * 0.125, dim=-1)
        assert torch.allclose(got[b], p @ lat[:, :dv], atol=1e-5)


def _k4_columns(n_splits, MB, bt, seq_len):
    """The block-table columns [begin, end) of each of K4's blocks of a row
    of length ``seq_len``, as csrc/paged_attention.cu computes them on the
    device: its ceil(seq_len / bt) live columns cut into n_splits ranges."""
    live = min(MB, -(-seq_len // bt)) if seq_len > 0 else 0
    per = -(-live // n_splits)
    return [(min(s * per, live), min(min(s * per, live) + per, live))
            for s in range(n_splits)]


# (B, MB, bt): the Moonlight cell (batch 64, 385 columns) and its smoke
# shapes, one long row, the small card-test tables, other block sizes
K4_PLANS = [(64, 385, 16), (64, 320, 16), (16, 8, 16), (1, 1024, 16),
            (1, 512, 16), (3, 40, 16), (2, 8, 16), (5, 64, 16), (128, 385, 16),
            (1, 4, 8), (4, 100, 32), (2, 3, 64)]
H100_SLOTS = 132          # one wave of K4: 132 SMs, one block an SM


@pytest.mark.parametrize("B,MB,bt", K4_PLANS)
def test_k4_split_plan_fills_one_wave(B, MB, bt):
    """n_splits from shapes alone: B rows of them fit one wave (or one
    block a row where B alone exceeds it), never more than the table's
    columns two stages at a time allow; the cell's shape takes two."""
    n = paged_ops._mla_split_plan(B, MB, bt, H100_SLOTS)
    assert 1 <= n <= paged_ops.MAX_SPLITS
    assert B * n <= max(H100_SLOTS, B)
    assert n <= max(1, -(-MB * bt // (2 * paged_ops.MLA_SLOTS)))
    if (B, MB) in ((64, 385), (64, 320)):
        assert n == 2


@pytest.mark.parametrize("B,MB,bt", K4_PLANS)
def test_k4_splits_share_the_live_columns(B, MB, bt):
    """Every live column of a row in exactly one block's range, in order,
    none past the row's length or the table, no range longer than
    ceil(live / n_splits): at the cell's 4 112 tokens its two blocks take 129
    and 128 of the 257 live columns, none of the 128 dead ones."""
    n = paged_ops._mla_split_plan(B, MB, bt, H100_SLOTS)
    for seq_len in sorted({0, 1, bt - 1, bt, bt + 1, 4112, MB * bt // 2 + 3,
                           MB * bt - 1, MB * bt, MB * bt + 5}):
        ranges = _k4_columns(n, MB, bt, seq_len)
        cols = [c for lo, hi in ranges for c in range(lo, hi)]
        live = min(MB, -(-seq_len // bt)) if seq_len > 0 else 0
        assert cols == list(range(live))
        assert max(hi - lo for lo, hi in ranges) == -(-live // n)
    if (B, MB, bt) == (64, 385, 16):
        assert [hi - lo for lo, hi in _k4_columns(n, MB, bt, 4112)] == [129, 128]


def test_latent_write_and_scatter_pooled():
    """The prefill scatter and the token write through pool-local frames
    land where the flattened pools' global frames say; unmapped rows store
    nothing."""
    P, F_, bt, dk = 2, 4, 4, 8
    slab = torch.zeros(P, F_, bt, 1, dk)
    phys = torch.tensor([[1, 0], [3, -1]], dtype=torch.int32)
    lat = torch.randn(2, 6, dk)
    pos = torch.arange(6)[None].expand(2, 6)
    scatter_latent(slab, lat, phys, pos, bt, pools=P)
    flat = slab.view(P * F_, bt, dk)
    glob = pooled_tables(phys, P, F_)
    assert glob.tolist() == [[1, 0], [7, -1]]
    for b in range(2):
        for t in range(6):
            f = int(glob[b, t // bt])
            if f >= 0:
                assert torch.equal(flat[f, t % bt], lat[b, t])
    assert int((flat != 0).any(-1).sum()) == 6 + 4       # row 1's last 2 dropped
    new = torch.randn(2, dk)
    write_latent(slab.flatten(0, 1), new, glob, torch.tensor([6, 5]), bt)
    assert torch.equal(flat[0, 2], new[0])
    assert int((flat != 0).any(-1).sum()) == 6 + 4 + 1


def test_spans_of_latent_attention_and_experts():
    """A prefill and a decode step record, in each layer, ``attn`` holding
    ``attn.latent`` then ``attn.kernel``, and in each MoE layer ``moe``
    holding ``moe.route`` {assignments}, ``moe.experts`` {experts, rows;
    load_max over segments} and ``moe.shared``."""
    cfg = F32
    params = init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 20
    state = init_decode_state(cfg, B, 2 * B, 2, device=CPU)
    phys = torch.arange(2 * B, dtype=torch.int32).view(B, 2)
    toks = torch.randint(0, cfg.vocab_size, (B, S))
    tracing.take()
    with torch.no_grad(), tracing.recording():
        _, state = prefill(cfg, params, toks, state, phys)
        decode_step(cfg, params, state, toks[:, 0], phys)
    recs = tracing.take()

    def kids(i):
        return [j for j, r in enumerate(recs) if r.parent == i]

    tops = [i for i, r in enumerate(recs) if r.parent < 0]
    assert [recs[i].name for i in tops] == ["prefill", "decode"]
    E, K = cfg.n_experts, cfg.experts_per_token
    for top, N in zip(tops, (B * S, B)):
        layers = [j for j in kids(top) if recs[j].name == "layer"]
        assert len(layers) == cfg.n_layers
        for n, lay in enumerate(layers):
            attn, ffn = kids(lay)
            assert [recs[j].name for j in kids(attn)] == ["attn.latent",
                                                          "attn.kernel"]
            if n < cfg.first_dense_layers:
                assert kids(ffn) == []
                continue
            (m,) = kids(ffn)
            route, experts, shared = kids(m)
            assert (recs[m].name, recs[route].name, recs[experts].name,
                    recs[shared].name) == ("moe", "moe.route", "moe.experts",
                                           "moe.shared")
            assert recs[route].counts == {"assignments": N * K}
            c = recs[experts].counts
            if N == B:                  # decode: every expert at capacity B
                assert c == {"experts": E, "rows": E * B}
            else:
                assert c["rows"] == N * K and 1 <= c["experts"] <= E
                assert N * K / E <= c["load_max"] <= N


def test_serve_on_the_cpu_pooled_numapte():
    """``serve()`` runs the smoke config through the cells' deployment on
    the CPU: waves, the walk, the prologue, the latent slabs."""
    from repro_torch.launch.serve import serve
    out = serve(ARCH, n_requests=3, prompt_len=20, gen_len=4, batch=2,
                n_pods=2, n_pools=2, replicas=True, mode="numapte", device="cpu",
                verbose=False)
    assert out["logits_finite"] and out["token_ids"].shape[-1] >= 4


# ------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (python -m pytest -m card "
                    "tests/test_torch_mla.py on one)")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("B,H,dv,dr,MB,N,dead,lens,bt", [
    (2, 16, 512, 64, 8, 32, False, None, 16),
    (3, 16, 512, 64, 40, 128, True, None, 16),
    (64, 16, 512, 64, 24, 64 * 24, False, None, 16),
    (2, 4, 512, 64, 8, 24, True, None, 16),
    (1, 16, 512, 64, 512, 512, False, None, 16),
    # the Moonlight cell's shape: equal rows of 4 112 that leave the table's
    # last quarter dead; then ragged rows of 1-6 144, some shorter than a
    # 64-slot stage; then a row that ends inside a stage beside a dead row
    (64, 16, 512, 64, 385, 64 * 385, False, 4112, 16),
    (64, 16, 512, 64, 385, 64 * 385, False, (1, 6144), 16),
    (2, 16, 512, 64, 70, 140, True, 1000, 16),
    # the other block sizes a stage divides into: 2 and 8 frames a stage
    (3, 16, 512, 64, 40, 128, True, None, 32),
    (5, 16, 512, 64, 64, 400, False, None, 8)])
def test_card_k4_matches_plain(card, B, H, dv, dr, MB, N, dead, lens, bt):
    """K4 within 5e-5 of its plain version, one launch, the combine's
    counters back at 0.  ``lens``: None draws each row's length from 1 to
    the table's MB * bt slots, an int gives every row that length, a pair
    (lo, hi) draws from lo to hi."""
    gen = torch.Generator(device=card).manual_seed(B * MB)
    q = torch.randn(B, H, dv + dr, generator=gen, device=card).bfloat16()
    slab = torch.randn(N, bt, 1, dv + dr, generator=gen,
                       device=card).bfloat16()
    perm = torch.randperm(N, generator=gen, device=card)[:B * MB]
    tables = perm.view(B, MB).int().contiguous()
    lo, hi = lens if isinstance(lens, tuple) else (1, MB * bt)
    lens = (torch.full((B,), lens, dtype=torch.int32, device=card)
            if isinstance(lens, int) else
            torch.randint(lo, hi + 1, (B,), generator=gen, device=card).int())
    if dead:
        tables[-1] = -1
    before = paged_ops.mla_decode.launches
    got = paged_ops.mla_decode(q, slab, tables, lens, scale=192 ** -0.5, dv=dv)
    want = mla_decode_ref(q, slab, tables, lens, scale=192 ** -0.5, dv=dv)
    torch.cuda.synchronize()
    assert paged_ops.mla_decode.launches == before + 1
    assert (got - want).abs().max().item() <= 5e-5
    assert all(int(c.abs().sum()) == 0 for c, _ in paged_ops._SCRATCH.values())


def _prefilled(cfg, device, B=4, S=24, steps=9, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen)
    bt = cfg.kv_block_tokens
    mb = -(-(S + steps) // bt) + 1
    state = init_decode_state(cfg, B, B * mb, mb, n_pools=2, device=device)
    # frames local to each row's pool, two rows a pool, each its own
    row = torch.arange(B, device=device) % (B // 2)
    phys = (row[:, None] * mb + torch.arange(mb, device=device)).int()
    phys[-1] = -1
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=device).int()
    with torch.no_grad():
        logits, state = prefill(cfg, params, prompts, state, phys)
    return params, state, phys, greedy_sample(logits)


@pytest.mark.card
@pytest.mark.parametrize("n_layers,seed", [(2, 1), (3, 0)],
                         ids=["published_widths_2_layers",
                              "published_widths_3_layers"])
def test_card_step_graphed_equals_eager(card, n_layers, seed):
    """Nine graphed steps (a capture, then replays) against nine eager ones
    from one prefilled state: tokens, lengths and every latent slab
    bit-equal, K4's launches counted alike, and each replay one ``decode``
    span counting ``graph`` = 1.  Published widths (K4's instance), a
    dense first layer and MoE layers after it."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers,
                              vocab_size=4096, param_dtype=torch.bfloat16)
    params, state, phys, tokens = _prefilled(cfg, card, seed=seed)
    copy = state._replace(caches=tree_map(torch.clone, state.caches),
                          seq_lens=state.seq_lens.clone())
    eager = specs.build_serve_step(cfg, sample=greedy_sample)
    graphed = specs.build_serve_step(cfg)
    runs = []
    for step, st in ((eager, copy), (graphed, state)):
        toks, k4, t = [], [], tokens
        tracing.take()
        with torch.no_grad(), tracing.recording():
            for _ in range(9):
                before = paged_ops.mla_decode.launches
                t, st = step(params, st, t, phys)
                k4.append(paged_ops.mla_decode.launches - before)
                toks.append(t.tolist())
        decodes = [r.counts for r in tracing.take() if r.name == "decode"]
        runs.append((toks, k4, st, decodes))
    (want, want_k4, want_st, eager_spans), (got, got_k4, got_st, spans) = runs
    assert got == want and got_k4 == want_k4 == [cfg.n_layers] * 9
    assert eager_spans == [{"graph": 0}] * 9
    assert spans == [{"graph": 0}] + [{"graph": 1}] * 8
    assert torch.equal(got_st.seq_lens, want_st.seq_lens)
    for a, b in zip(tree_leaves(got_st.caches), tree_leaves(want_st.caches)):
        assert torch.equal(a, b)
