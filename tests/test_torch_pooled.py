"""Pool-partitioned KV and sequence-parallel decode of the port against the
reference's no-mesh forms (``repro.kvcache.gather``), same numpy inputs:
the pooled prefill scatter, ``decode_attention_sp``
over ``LoopPods(2)`` and ``LoopPods(4)`` (float32 within 5e-5, K1's bound;
bfloat16 within rel 0.03, since the reference rounds P to bf16 and the port
does not, ROADMAP queue 3), and pooled ``prefill`` / ``decode_step`` of the
smoke configs against the reference's ``init_decode_state(n_pools=2)``
(float32 within 2e-4, bfloat16 rel 0.03).  Last, the reference's own
layout mismatch between its pooled prefill and its SP decode (queue 3)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jpaged  # noqa: E402
from repro.kvcache import gather as jg  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.distributed import LoopPods  # noqa: E402
from repro_torch.kvcache import gather as tg  # noqa: E402
from test_torch_models import _close, _f32, _setup  # noqa: E402

BT, K, G, HD = 4, 2, 2, 16
DT = {"f32": (np.float32, jnp.float32, torch.float32),
      "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(a, dtype):
    """The same values as a jnp and a torch array of ``dtype``."""
    _, jd, td = DT[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.array(a)).to(td)


def _check(got, want, dtype, what, atol=5e-5):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=atol, err_msg=what)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 0.03, (what, rel)


def _pooled_case(rng, P, B, MB, F):
    """Slabs [P, F, bt, K, hd]; tables of pool-local frames, row b in pool
    b // (B / P), the last row padding (all -1)."""
    slabs = [_rand(rng, (P, F, BT, K, HD)) for _ in range(2)]
    tables = np.full((B, MB), -1, np.int32)
    pool_of = np.arange(B) // max(B // P, 1)
    for p in range(P):
        rows = np.flatnonzero(pool_of == p)
        frames = rng.permutation(F)
        for j, b in enumerate(rows):
            tables[b] = frames[j * MB:(j + 1) * MB]
    tables[-1] = -1
    return slabs, tables


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_scatter_prefill_pooled_matches_jax(dtype):
    """The prefill scatter of a prompt of S tokens into two pools, frames
    local to each row's pool, the last row padding: bit-equal slabs."""
    rng = np.random.default_rng(1)
    P, B, MB, F = 2, 4, 5, 12
    (ks, vs), tables = _pooled_case(rng, P, B, MB, F)
    jks, tks = _pair(ks, dtype)
    jvs, tvs = _pair(vs, dtype)
    S = 9
    k = _rand(rng, (B, S, K, HD))
    positions = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jk, tk = _pair(k, dtype)
    want = jg.scatter_prefill_pooled(jks, jvs, jk, jk, jnp.asarray(tables),
                                     jnp.asarray(positions), BT)
    got = tg.scatter_prefill_pooled(tks, tvs, tk, tk, torch.from_numpy(tables),
                                    torch.from_numpy(positions), BT)
    assert got[0] is tks
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_f32(g), _f32(w))


def _sp_case(rng, n, B, MB, F, lens):
    """Column c of every row in pool c // (MB / n), local frames unique in
    each pool; ``lens`` [B] tokens including the new one."""
    MBl = MB // n
    tables = np.full((B, MB), -1, np.int32)
    for s in range(n):
        frames = rng.permutation(F)[:B * MBl].reshape(B, MBl)
        tables[:, s * MBl:(s + 1) * MBl] = frames
    lens = np.asarray(lens, np.int32)
    nb = -(-lens // BT)
    tables[np.arange(MB)[None, :] >= nb[:, None]] = -1
    slabs = [_rand(rng, (n, F, BT, K, HD)) for _ in range(2)]
    q = _rand(rng, (B, K * G, HD))
    new = [_rand(rng, (B, K, HD)) for _ in range(2)]
    return q, slabs, new, tables, lens


@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_torch_decode_attention_sp_matches_jax(n, dtype, window):
    """Over LoopPods(n) and in the no-mesh form; one row reaches the last
    shard, one ends in the first (the shards past it have no live slot:
    their partial is 0 with LSE NEG_INF and must drop out of the combine),
    one ends on a shard boundary."""
    rng = np.random.default_rng(10 * n + (window or 0))
    MB, F = 4 * n, 16
    lens = [MB * BT - 1, 3, (MB // n) * BT]
    q, (ks, vs), (kn, vn), tables, lens = _sp_case(rng, n, 3, MB, F, lens)
    args = [_pair(a, dtype) for a in (q, ks, vs, kn, vn)]
    kw = dict(block_tokens=BT, n_kv=K, window=window)
    want = jg.decode_attention_sp(*(a[0] for a in args), jnp.asarray(tables),
                                  jnp.asarray(lens - 1), jnp.asarray(lens), **kw)
    for pods in (None, LoopPods(n, "cpu")):
        tks, tvs = args[1][1].clone(), args[2][1].clone()
        got = tg.decode_attention_sp(args[0][1], tks, tvs, args[3][1], args[4][1],
                                     torch.from_numpy(tables),
                                     torch.from_numpy(lens - 1),
                                     torch.from_numpy(lens), pods=pods, **kw)
        assert got[0].dtype == torch.float32 and got[1] is tks
        _check(got[0], want[0], dtype, f"sp out, pods={pods}")
        for g, w in zip(got[1:], want[1:]):      # the token went to its pool
            np.testing.assert_array_equal(_f32(g), _f32(w))
    if pods is not None:                 # one max and two sums of partials
        assert pods.calls == {"pmax": 1, "psum": 2}


def _pooled_tables(rng, B, MB, P, F):
    tables = np.full((B, MB), -1, np.int32)
    for p in range(P):
        frames = rng.permutation(F)
        for j, b in enumerate(range(p * B // P, (p + 1) * B // P)):
            tables[b] = frames[j * MB:(j + 1) * MB]
    tables[-1] = -1                               # a padding row
    return tables


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["qwen3_14b", "gemma3_4b", "qwen3_moe_235b_a22b"])
def test_torch_pooled_prefill_and_decode_match_jax(arch, dtype):
    """Two pools: rows 0-1 in pool 0, rows 2-3 (3 is padding) in pool 1,
    frames local to each; prefill, then three decode steps, logits and slabs
    against the reference's."""
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype)
    B, S, STEPS, P = 4, 20, 3, 2
    bt = jcfg.kv_block_tokens
    MB = (S + STEPS + bt - 1) // bt + 1
    F = 2 * MB + 3
    rng = np.random.default_rng(4)
    tables = _pooled_tables(rng, B, MB, P, F)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jstate = jm.init_decode_state(jcfg, B, P * F, MB, n_pools=P)
    tstate = tm.init_decode_state(tcfg, B, P * F, MB, n_pools=P, device="cpu")
    g = next(i for i, c in enumerate(tstate.caches) if "k_slabs" in c)
    assert tuple(tstate.caches[g]["k_slabs"].shape[1:3]) == (P, F)
    jl, jstate = jm.prefill(jcfg, jparams, jnp.asarray(tokens), jstate,
                            jnp.asarray(tables))
    tl, tstate = tm.prefill(tcfg, tparams, torch.from_numpy(tokens), tstate,
                            torch.from_numpy(tables))
    _close(tl[:3], jl[:3], dtype, "prefill logits")
    jtok = jm.greedy_sample(jl)
    for step in range(STEPS):
        ttok = torch.from_numpy(np.array(jtok))
        jl, jstate = jm.decode_step(jcfg, jparams, jstate, jtok,
                                    jnp.asarray(tables))
        tl, tstate = tm.decode_step(tcfg, tparams, tstate, ttok,
                                    torch.from_numpy(tables))
        _close(tl[:3], jl[:3], dtype, f"decode step {step}")
        jtok = jm.greedy_sample(jl)
    for name in ("k_slabs", "v_slabs"):
        _close(tstate.caches[g][name], jstate.caches[g][name], dtype, name)


def _sp_layout(one_pool, tables, n, F):
    """Harness: the one-pool slabs [L, N, ...] of a prefill moved into the
    SP layout [L, n, F, ...], column c of a row in pool c // (MB / n).
    Returns (pooled slabs, pool-local tables)."""
    B, MB = tables.shape
    MBl = MB // n
    L = one_pool.shape[0]
    out = np.zeros((L, n, F) + one_pool.shape[2:], one_pool.dtype)
    local = np.full_like(tables, -1)
    for s in range(n):
        cols = tables[:, s * MBl:(s + 1) * MBl]
        live = cols >= 0
        local[:, s * MBl:(s + 1) * MBl][live] = np.arange(live.sum())
        out[:, s, :live.sum()] = one_pool[:, cols[live]]
    return out, local


def _sp_states(tcfg, tparams, n, B=2, S=21, steps=4, seed=5):
    """A prompt of S tokens prefilled into a one-pool state, and the same
    state moved into the SP column layout over n pools.  Returns (first
    token, one-pool state, its tables, SP state, its pool-local tables)."""
    bt = tcfg.kv_block_tokens
    MB = -(-(-(-(S + steps) // bt) + 1) // n) * n
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    tables = rng.permutation(B * MB).astype(np.int32).reshape(B, MB)
    one = tm.init_decode_state(tcfg, B, B * MB, MB, device="cpu")
    logits, one = tm.prefill(tcfg, tparams, torch.from_numpy(tokens), one,
                             torch.from_numpy(tables))
    F = B * MB // n
    sp = tm.init_decode_state(tcfg, B, n * F, MB, n_pools=n, device="cpu")
    for name in ("k_slabs", "v_slabs"):
        moved, local = _sp_layout(one.caches[0][name].numpy(), tables, n, F)
        sp.caches[0][name].copy_(torch.from_numpy(moved))
    sp = sp._replace(seq_lens=one.seq_lens.clone())
    return tm.greedy_sample(logits), one, tables, sp, local


@pytest.mark.parametrize("n", [2, 4])
def test_torch_sp_decode_step_matches_jax(n):
    """decode_step(sp=True) over LoopPods(n) against the reference's
    decode_step(sp=True) (its no-mesh form), from one prefilled state moved
    into the column layout; then against the one-pool decode, float32."""
    jcfg, tcfg, jparams, tparams = _setup("qwen3_14b", "f32")
    STEPS = 4
    tok, one, tables, sp, local = _sp_states(tcfg, tparams, n, steps=STEPS)
    jstate = jm.DecodeState(tuple({k: jnp.asarray(v.numpy()) for k, v in c.items()}
                                  for c in sp.caches), jnp.asarray(one.seq_lens))
    pods = LoopPods(n, "cpu")
    for step in range(STEPS):
        jl, jstate = jm.decode_step(jcfg, jparams, jstate, jnp.asarray(tok),
                                    jnp.asarray(local), sp=True)
        sl, sp = tm.decode_step(tcfg, tparams, sp, tok, torch.from_numpy(local),
                                sp=True, pods=pods)
        ol, one = tm.decode_step(tcfg, tparams, one, tok, torch.from_numpy(tables))
        _close(sl, jl, "f32", f"sp step {step} vs reference")
        _close(sl, ol, "f32", f"sp step {step} vs one pool")
        tok = tm.greedy_sample(ol)
        assert torch.equal(tm.greedy_sample(sl), tok)


def test_reference_pooled_prefill_and_sp_decode_disagree_on_the_layout():
    """ROADMAP queue 3: the reference's no-mesh ``scatter_prefill_pooled``
    puts a row's frames in pool ``b // max(B / P, 1)``, its no-mesh
    ``decode_attention_sp`` reads column c from pool ``c // (MB / P)``.  At
    B = 1, P = 2 a 12-token prompt over 4 columns leaves pool 1 all zeros,
    and the SP decode that follows is far from plain attention.  The port
    keeps both functions as they are (parity) and gives SP decode no prefill
    of its own: this pins the reference's behaviour and the port's."""
    rng = np.random.default_rng(0)
    P, MB, F, S = 2, 4, 4, 12
    k, v = _rand(rng, (1, S, K, HD)), _rand(rng, (1, S, K, HD))
    tables = np.array([[0, 1, 2, 3]], np.int32)
    positions = np.arange(S, dtype=np.int32)[None]
    zeros = jnp.zeros((P, F, BT, K, HD), jnp.float32)
    ks, vs = jg.scatter_prefill_pooled(zeros, zeros, jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(tables), jnp.asarray(positions), BT)
    assert not np.asarray(ks[1]).any() and np.asarray(ks[0]).any()
    q, kn, vn = _rand(rng, (1, K * G, HD)), _rand(rng, (1, K, HD)), _rand(rng, (1, K, HD))
    lens = np.array([S + 1], np.int32)
    sp, _, _ = jg.decode_attention_sp(jnp.asarray(q), ks, vs, jnp.asarray(kn),
                                      jnp.asarray(vn), jnp.asarray(tables),
                                      jnp.asarray(lens - 1), jnp.asarray(lens),
                                      block_tokens=BT, n_kv=K)
    # plain attention over the prompt and the new token, one pool
    k_all, v_all = np.zeros((2, MB * BT, K, HD), np.float32)
    k_all[:S + 1] = np.concatenate([k[0], kn])
    v_all[:S + 1] = np.concatenate([v[0], vn])
    plain = jpaged(jnp.asarray(q), jnp.asarray(k_all.reshape(MB, BT, K, HD)),
                   jnp.asarray(v_all.reshape(MB, BT, K, HD)),
                   jnp.asarray(tables), jnp.asarray(lens))
    off = float(np.abs(np.asarray(sp) - np.asarray(plain)).max())
    assert off > 0.1, off
    print(f"reference SP decode after its pooled prefill: {off:.4f} off plain")
    # the port reproduces the reference's result on the same slabs
    got, _, _ = tg.decode_attention_sp(
        torch.from_numpy(q), torch.from_numpy(np.array(ks)),
        torch.from_numpy(np.array(vs)), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(tables), torch.from_numpy(lens - 1),
        torch.from_numpy(lens), block_tokens=BT, n_kv=K, pods=LoopPods(P, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(sp), atol=5e-5)


def test_reference_pooled_rows_past_the_pools_write_another_pool():
    """ROADMAP queue 3: with B not a multiple of P the reference's row pool
    ``b // max(B // P, 1)`` runs past the last pool (B = 3, P = 2: row 2 ->
    pool 2).  Its frames then index past the flattened pools, and the
    clamped write lands in pool 1's last frame, which another row may own.
    The port refuses such a batch."""
    P, F, B = 2, 4, 3
    ks = jnp.zeros((P, F, BT, K, HD))
    tables = np.array([[0, 1]] * B, np.int32)
    kn = jnp.ones((B, K, HD)) * jnp.arange(1, B + 1)[:, None, None]
    k2, _, _, _ = jg.update_gather_pooled(ks, ks, kn, kn, jnp.asarray(tables),
                                          jnp.asarray([1, 1, 5], jnp.int32), BT)
    k2 = np.asarray(k2)
    assert (k2[1, F - 1, 1] == 3).all()          # row 2's token, in pool 1
    prompt = torch.ones((B, 2, K, HD))
    with pytest.raises(ValueError, match="split over"):
        tg.scatter_prefill_pooled(torch.zeros(P, F, BT, K, HD),
                                  torch.zeros(P, F, BT, K, HD), prompt, prompt,
                                  torch.from_numpy(tables),
                                  torch.arange(2, dtype=torch.int32).expand(B, 2),
                                  BT)


@pytest.mark.parametrize("window", [None, 6])
def test_torch_paged_attention_lse_of_the_plain_version(window):
    """K1's plain version with ``lse``: ln sum exp(scale q.k) over each
    row's live slots, in float64 numpy from the same inputs; NEG_INF for a
    row with no live slot (a length <= 0 or an all-absent table)."""
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import NEG_INF
    rng = np.random.default_rng(9)
    B, MB, N = 5, 4, 20
    q, ks, vs = _rand(rng, (B, K * G, HD)), _rand(rng, (N, BT, K, HD)), \
        _rand(rng, (N, BT, K, HD))
    tables = rng.permutation(N)[:B * MB].reshape(B, MB).astype(np.int32)
    tables[3] = -1
    tables[1, 2] = -1
    lens = np.array([13, 16, 0, 9, -4], np.int32)
    lse = torch.empty((B, K * G))
    out = paged_attention(*map(torch.from_numpy, (q, ks, vs, tables, lens)),
                          window=window, lse=lse)
    assert out.shape == (B, K * G, HD)
    for b in range(B):
        t = np.arange(MB * BT)
        live = (t < lens[b]) & (np.repeat(tables[b], BT) >= 0)
        if window is not None:
            live &= t >= lens[b] - window
        for h in range(K * G):
            if not live.any():
                assert lse[b, h] == NEG_INF
                continue
            frames = np.repeat(tables[b], BT)[live]
            k = ks[frames, t[live] % BT, h // G].astype(np.float64)
            s = k @ q[b, h].astype(np.float64) * HD ** -0.5
            want = np.log(np.exp(s - s.max()).sum()) + s.max()
            assert abs(float(lse[b, h]) - want) < 1e-5
