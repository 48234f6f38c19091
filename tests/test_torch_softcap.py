"""The attention logit soft-cap on every path of the port, on the CPU.

The reference caps the scaled scores in its plain ``_gqa_scores``
(``src/repro/models/attention.py``): ``s = tanh(s / c) * c`` after the
``hd ** -0.5`` scale and before the mask.  Here, in float32:

  * the plain K1 (``paged_attention_ref``) and K2 (``flash_attention_ref``,
    its LSE, and ``flash_attention_bwd_ref``) with a cap against the
    reference's ``_gqa_scores`` at caps 30, 5 and 0.5: outputs and LSEs
    within 1e-5, gradients (of the JAX function, by ``jax.vjp``) within
    1e-4 of their largest magnitude, also through ``FlashAttentionFn`` and
    the ``paged_attention`` wrapper (a CPU tensor takes the plain version);
  * ``forward_lm`` / ``forward_encdec``, ``prefill`` (``prefill_encdec``) +
    2 ``decode_step``s, and ``lm_loss`` with its gradients, with cap 5, for
    Yi-6B (global attention), Gemma-3 (rings and global layers), Recurrent
    Gemma (the RG-LRU beside windowed rings) and Whisper (the encoder and
    the cross-attention), against the reference's functions
    (``kernel="ref"``) within 1e-4, at model 1 and at model 2 over
    ``LoopPods`` (the ``_tp`` variants), the latter with Megatron sequence
    parallelism on (``test_torch_seq_parallel.py`` holds it bit-equal to
    the run without, and holds the other families against the reference);
  * sequence-parallel decode (``decode_attention_sp``, no mesh and over
    ``LoopPods(2)``) against the plain K1 on the whole table;
  * the reference's gap, pinned: its ``kernel="pallas"`` decode (the
    interpret-mode Pallas kernel) skips the cap, while its ``kernel="ref"``
    decode and the port's decode both match ``forward_lm``.

The reference's jitted functions are built once a module (``lru_cache``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jm  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.distributed import LoopPods  # noqa: E402
from repro_torch.distributed.sharding import use_rules  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import visible_mask  # noqa: E402
from repro_torch.kernels.paged_attention import (paged_attention,  # noqa: E402
                                                 paged_attention_ref)
from repro_torch.kvcache import gather as tg  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models.transformer import gather_vocab, vocab_split  # noqa: E402
from test_torch_models import _setup  # noqa: E402
from test_torch_train import _unstacked_pairs  # noqa: E402

CAPS = [30.0, 5.0, 0.5]
NEG_INF = -2.0 ** 30
MODEL_CAP = 5.0
ARCHS = ["yi_6b", "gemma3_4b", "recurrentgemma_2b", "whisper_base"]
B, S, STEPS, SE = 2, 37, 2, 24
REF_REL = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jcfg(K: int, cap: float):
    """A reference config whose ``_gqa_scores`` caps at ``cap`` over K kv
    heads."""
    return dataclasses.replace(jconfigs.get_smoke_config("yi_6b"),
                               n_kv_heads=K, attn_logit_softcap=cap,
                               dtype=jnp.float32)


def _jax_attention(cap, q, k, v, mask):
    """The reference's plain attention: q [B,Sq,H,hd], k/v [B,Sk,K,hd],
    mask [B,Sq,Sk] -> (out [B,Sq,H,hd], lse [B,K,G,Sq])."""
    K = k.shape[2]
    s = jattn._gqa_scores(_jcfg(K, cap), q, k)           # [B,K,G,Sq,Sk]
    s = jnp.where(mask[:, None, None], s, NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    out = jnp.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(q.shape), jax.nn.logsumexp(s, axis=-1)


@pytest.mark.parametrize("cap", CAPS)
def test_torch_flash_attention_softcap_matches_the_reference_scores(cap):
    """K2's plain version with a cap, forward, LSE and gradient, against the
    reference's capped scores (causal with a window, GQA)."""
    rng = np.random.default_rng(int(cap * 10))
    Bq, H, K, Sq, hd, window = 2, 4, 2, 40, 16, 24
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32) * 2
                     for shape in ((Bq, H, Sq, hd), (Bq, K, Sq, hd),
                                   (Bq, K, Sq, hd), (Bq, H, Sq, hd)))
    mask = np.broadcast_to(visible_mask(Sq, True, window).numpy(), (Bq, Sq, Sq))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_attention_ref(tq, tk, tv, causal=True, window=window,
                                   softcap=cap, return_lse=True)

    def ref(q_, k_, v_):
        o, l_ = _jax_attention(cap, q_.transpose(0, 2, 1, 3),
                               k_.transpose(0, 2, 1, 3),
                               v_.transpose(0, 2, 1, 3), jnp.asarray(mask))
        return o.transpose(0, 2, 1, 3), l_
    (want, want_lse), vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(
        Bq, H, Sq), atol=1e-5)
    grads = vjp((jnp.asarray(dout), jnp.zeros_like(want_lse)))
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, torch.from_numpy(dout),
                                  causal=True, window=window, softcap=cap)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o = flash_attention(*leaves, causal=True, window=window, softcap=cap)
    o.backward(torch.from_numpy(dout))
    for name, g, fn_g, w in zip("qkv", got, leaves, grads):
        assert _rel(g.numpy(), w) <= 1e-4, name
        assert _rel(fn_g.grad.numpy(), w) <= 1e-4, name
    # the cap changes the result where it bites: a dropped cap shows
    plain = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    if cap < 30:
        assert float((plain - out).abs().max()) > 1e-2


@pytest.mark.parametrize("cap", CAPS)
def test_torch_paged_attention_softcap_matches_the_reference_scores(cap):
    """K1's plain version with a cap (its output and LSE, a window, a dead
    row) against the reference's capped scores over the gathered blocks;
    the wrapper on a CPU tensor takes it."""
    rng = np.random.default_rng(int(cap * 10) + 1)
    Bq, H, K, hd, bt, MB, N = 3, 8, 2, 16, 4, 6, 24
    q = rng.standard_normal((Bq, H, hd)).astype(np.float32) * 2
    ks, vs = (rng.standard_normal((N, bt, K, hd)).astype(np.float32)
              for _ in range(2))
    tables = rng.permutation(N)[:Bq * MB].reshape(Bq, MB).astype(np.int32)
    lens = np.array([MB * bt - 3, 9, 0], np.int32)
    tables[2] = -1                                  # a dead row
    window = 12
    args = [torch.from_numpy(a) for a in (q, ks, vs, tables, lens)]
    out, lse = paged_attention_ref(*args, window=window, softcap=cap,
                                   return_lse=True)
    k = ks[np.maximum(tables, 0)].reshape(Bq, MB * bt, K, hd)
    v = vs[np.maximum(tables, 0)].reshape(Bq, MB * bt, K, hd)
    t = np.arange(MB * bt)[None]
    live = (t < lens[:, None]) & (t >= lens[:, None] - window)
    live &= np.repeat(tables >= 0, bt, axis=1)
    want, want_lse = _jax_attention(cap, jnp.asarray(q[:, None]),
                                    jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(live[:, None]))
    want = np.asarray(want)[:, 0] * live.any(1)[:, None, None]
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    want_lse = np.where(live.any(1)[:, None], np.asarray(want_lse).reshape(
        Bq, H), NEG_INF)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)
    lse2 = torch.empty((Bq, H))
    np.testing.assert_array_equal(
        paged_attention(*args, window=window, softcap=cap, lse=lse2).numpy(),
        out.numpy())
    np.testing.assert_array_equal(lse2.numpy(), lse.numpy())
    if cap < 30:
        plain = paged_attention_ref(*args, window=window)
        assert float((plain - out).abs().max()) > 1e-2


# ------------------------------------------------------------------- models
def _setup_cap(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch, "f32")
    return (dataclasses.replace(jcfg, attn_logit_softcap=MODEL_CAP),
            dataclasses.replace(tcfg, attn_logit_softcap=MODEL_CAP),
            jparams, tparams)


def _inputs(jcfg):
    bt = jcfg.kv_block_tokens
    MB = (S + STEPS + bt - 1) // bt + 1
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    phys = rng.permutation(B * MB).astype(np.int32).reshape(B, MB)
    loss_batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                         (B, S + 1)).astype(np.int32)}
    feats = None
    if jcfg.family == "encdec":
        feats = rng.standard_normal((B, SE, jcfg.d_model)).astype(np.float32)
        loss_batch["enc_feats"] = feats
    return tokens, phys, MB, loss_batch, feats


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's capped forward logits, prefill + decode logits (its
    own greedy tokens), loss and gradients, each function jitted."""
    jcfg, _, jparams, _ = _setup_cap(arch)
    tokens, phys, MB, loss_batch, feats = _inputs(jcfg)
    jit = lambda fn, **kw: jax.jit(functools.partial(fn, jcfg, **kw))
    if jcfg.family == "encdec":
        fwd = jit(jm.forward_encdec, remat=False)(
            jparams, jnp.asarray(feats), jnp.asarray(tokens))[0]
        state = jm.init_decode_state(jcfg, B, B * MB, MB, enc_len=SE)
        lg, state = jit(jtr.prefill_encdec)(jparams, jnp.asarray(feats),
                                            jnp.asarray(tokens), state,
                                            jnp.asarray(phys))
    else:
        fwd = jit(jm.forward_lm, remat=False)(jparams, jnp.asarray(tokens))[0]
        state = jm.init_decode_state(jcfg, B, B * MB, MB)
        lg, state = jit(jm.prefill)(jparams, jnp.asarray(tokens), state,
                                    jnp.asarray(phys))
    steps, toks = [np.asarray(lg)], []
    decode = jit(jm.decode_step, kernel="ref")
    for _ in range(STEPS):
        tok = jm.greedy_sample(lg)
        toks.append(np.asarray(tok))
        lg, state = decode(jparams, state, tok, jnp.asarray(phys))
        steps.append(np.asarray(lg))
    jb = {k: jnp.asarray(v) for k, v in loss_batch.items()}
    (total, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.lm_loss(jcfg, p, jb, remat=False), has_aux=True))(jparams)
    return {"forward": np.asarray(fwd), "decode": steps, "tokens": toks,
            "loss": float(total), "grads": grads}


def _port(arch, t):
    """The port's capped forward, prefill + decode (fed the reference's
    tokens), loss and whole gradients on a model axis of t (1: none; 2:
    with sequence parallelism)."""
    jcfg, tcfg, _, tparams = _setup_cap(arch)
    tokens, phys, MB, loss_batch, feats = _inputs(jcfg)
    ref = _reference(arch)
    grid = make_debug_mesh(1, model=t, device="cpu")
    tp = grid.model if t > 1 else None
    rules = specs.make_rules(tcfg, grid, specs.PerfOptions(seq_parallel=t > 1))
    params = specs.shard_params(tparams, grid, tcfg)
    whole = ((lambda lg: gather_vocab(lg, tp))
             if tp is not None and vocab_split(params) else (lambda lg: lg))
    encdec = tcfg.family == "encdec"
    out = {}
    with torch.no_grad(), use_rules(rules):
        if encdec:
            fwd = tm.forward_encdec(tcfg, params, torch.from_numpy(feats),
                                    torch.from_numpy(tokens), tp)[0]
        else:
            fwd = tm.forward_lm(tcfg, params, torch.from_numpy(tokens), tp)[0]
        out["forward"] = whole(fwd).numpy()
        split = specs.kv_split(tcfg, grid) if t > 1 else 1
        rec = specs.state_split(params, grid) if t > 1 else 1
        state = tm.init_decode_state(tcfg, B, B * MB, MB,
                                     enc_len=SE if encdec else 0,
                                     kv_split=split, state_split=rec,
                                     device="cpu")
        tphys = torch.from_numpy(phys)
        if encdec:
            lg, state = tm.prefill_encdec(tcfg, params, torch.from_numpy(feats),
                                          torch.from_numpy(tokens), state,
                                          tphys, tp=tp)
        else:
            lg, state = tm.prefill(tcfg, params, torch.from_numpy(tokens),
                                   state, tphys, tp=tp)
        steps = [whole(lg).numpy()]
        for tok in ref["tokens"]:
            lg, state = tm.decode_step(tcfg, params, state,
                                       torch.from_numpy(np.array(tok)), tphys,
                                       tp=tp)
            steps.append(whole(lg).numpy())
    out["decode"] = steps
    batch = {k: torch.from_numpy(v) for k, v in loss_batch.items()}
    with use_rules(rules):
        total, _, grads = specs._grads(tcfg, params, batch, tp)
    it = iter(grads)
    gtree = tree_map(lambda _: next(it), params)
    out["loss"] = float(total)
    out["grads"] = specs.gather_params(gtree, grid) if t > 1 else gtree
    return out


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_torch_softcap_models_match_the_reference(arch, t):
    """Every attention path with the cap: prefill attention (K2's plain
    version, global and windowed, the encoder's), the paged decode (K1's),
    the ring decode, the cross-attention, their ``_tp`` variants at t = 2,
    and the training gradient through ``FlashAttentionFn``."""
    ref, got = _reference(arch), _port(arch, t)
    assert _rel(got["forward"], ref["forward"]) <= REF_REL
    for i, (g, w) in enumerate(zip(got["decode"], ref["decode"])):
        assert _rel(g, w) <= REF_REL, f"step {i}"
    assert abs(got["loss"] - ref["loss"]) <= REF_REL * abs(ref["loss"])
    _, _, _, tparams = _setup(arch, "f32")
    n = 0
    for name, _, j_leaf in _unstacked_pairs(ref["grads"], tparams):
        node = got["grads"]
        for k in name.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        assert _rel(node.numpy(), np.asarray(j_leaf)) <= REF_REL, name
        n += 1
    assert n == len(tree_leaves(tparams))


@pytest.mark.parametrize("n", [1, 2])
def test_torch_softcap_sequence_parallel_decode(n):
    """``decode_attention_sp`` with a cap (each shard's K1 caps its scores;
    the LSEs are of the capped scores, so the combine is unchanged), in the
    no-mesh form and over ``LoopPods(2)``, against the plain K1 on the whole
    table."""
    rng = np.random.default_rng(3)
    P, Bq, H, K, hd, bt, MB, F = 2, 3, 8, 2, 16, 4, 8, 16
    MBl = MB // P
    tables = np.full((Bq, MB), -1, np.int32)
    for s_ in range(P):
        tables[:, s_ * MBl:(s_ + 1) * MBl] = rng.permutation(F)[
            :Bq * MBl].reshape(Bq, MBl)
    lens = np.array([MB * bt - 1, 3, MBl * bt], np.int32)
    tables[np.arange(MB)[None] >= (-(-lens // bt))[:, None]] = -1
    q = torch.from_numpy(rng.standard_normal((Bq, H, hd)).astype(np.float32) * 2)
    ks, vs = (torch.from_numpy(rng.standard_normal((P, F, bt, K, hd))
                               .astype(np.float32)) for _ in range(2))
    kn, vn = (torch.from_numpy(rng.standard_normal((Bq, K, hd))
                               .astype(np.float32)) for _ in range(2))
    pods = None if n == 1 else LoopPods(P, "cpu")
    tks, tvs = ks.clone(), vs.clone()
    got, _, _ = tg.decode_attention_sp(
        q, tks, tvs, kn, vn, torch.from_numpy(tables),
        torch.from_numpy(lens - 1), torch.from_numpy(lens), block_tokens=bt,
        n_kv=K, pods=pods, softcap=MODEL_CAP)
    glob = tg.sp_tables(torch.from_numpy(tables), P, F)
    want = paged_attention_ref(q, tks.flatten(0, 1), tvs.flatten(0, 1), glob,
                               torch.from_numpy(lens), softcap=MODEL_CAP)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    plain = paged_attention_ref(q, tks.flatten(0, 1), tvs.flatten(0, 1), glob,
                                torch.from_numpy(lens))
    assert float((plain - want).abs().max()) > 1e-2


def test_reference_pallas_decode_drops_the_softcap():
    """The reference's gap, pinned (ROADMAP queue 3): with the cap, its
    ``kernel="pallas"`` paged decode (the Pallas kernel in interpret mode)
    misses ``forward_lm``'s last logits by far more than its ``"ref"``
    decode does; the port's decode step matches the ``"ref"`` one."""
    jcfg, tcfg, jparams, tparams = _setup_cap("yi_6b")
    prompt = 47
    bt = jcfg.kv_block_tokens
    MB = prompt // bt + 2
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (B, prompt + 1)).astype(np.int32)
    phys = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    want = np.asarray(jm.forward_lm(jcfg, jparams, jnp.asarray(tokens),
                                    remat=False)[0])[:, -1]
    state = jm.init_decode_state(jcfg, B, B * MB, MB)
    _, state = jm.prefill(jcfg, jparams, jnp.asarray(tokens[:, :prompt]),
                          state, jnp.asarray(phys))
    got = {kernel: np.asarray(jm.decode_step(
        jcfg, jparams, state, jnp.asarray(tokens[:, prompt]),
        jnp.asarray(phys), kernel=kernel)[0]) for kernel in ("ref", "pallas")}
    assert _rel(got["ref"], want) <= 1e-5
    assert _rel(got["pallas"], want) > 1e-2
    tstate = tm.init_decode_state(tcfg, B, B * MB, MB, device="cpu")
    with torch.no_grad():
        _, tstate = tm.prefill(tcfg, tparams, torch.from_numpy(tokens[:, :prompt]),
                               tstate, torch.from_numpy(phys))
        port, _ = tm.decode_step(tcfg, tparams, tstate,
                                 torch.from_numpy(tokens[:, prompt]),
                                 torch.from_numpy(phys))
    assert _rel(port.numpy(), got["ref"]) <= 1e-5
