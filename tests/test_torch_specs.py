"""The step builders of the pod axis (``repro_torch.launch.specs``) against
the reference's (``repro.launch.specs``): the train step without a mesh and
the sequence-parallel serve step; then what only the port runs on one
device: the serve step's coherence prologue over ``LoopPods`` inside
``serve()`` (tokens equal across the modes and the one-pool run, every
replica checked each step) and the train step over pods with the float32
and the int8 error-feedback pod legs."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.distributed import LoopPods, compression  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, cosine_lr  # noqa: E402
from test_torch_models import _setup  # noqa: E402
from test_torch_pooled import _sp_states  # noqa: E402


@pytest.mark.parametrize("n", [2, 4])
def test_torch_sp_serve_step_matches_reference(n):
    """build_serve_step(sp=True) over LoopPods(n) against the reference's
    build_serve_step(sp=True) (its no-mesh form) from the same state in the
    SP column layout: the same greedy tokens every step."""
    jcfg, tcfg, jparams, tparams = _setup("qwen3_14b", "f32")
    tok, _, _, sp, local = _sp_states(tcfg, tparams, n, steps=3, seed=n)
    jstate = jm.DecodeState(tuple({k: jnp.asarray(v.numpy()) for k, v in c.items()}
                                  for c in sp.caches), jnp.asarray(sp.seq_lens))
    jstep = jspecs.build_serve_step(jcfg, sp=True)
    tstep = specs.build_serve_step(tcfg, sp=True, pods=LoopPods(n, "cpu"))
    jtok = jnp.asarray(tok)
    for step in range(3):
        jtok, jstate = jstep(jparams, jstate, jtok, jnp.asarray(local))
        tok, sp = tstep(tparams, sp, tok, torch.from_numpy(local))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {step}")


def test_torch_serve_refuses_replicas_without_a_coherence_mode():
    with pytest.raises(ValueError, match="coherence mode"):
        serve("qwen3_14b", mode="local", n_pools=4, replicas=True,
              device="cpu", verbose=False)


def test_torch_serve_step_coherence_modes_over_loop_pods():
    """serve() over 4 pools and 4 LoopPods: the prologue runs every step in
    eager and numaPTE, every replica agrees with the host after every step,
    and the tokens equal the one-pool run's (the prologue maintains the
    replicas; the decode reads the walked table)."""
    kw = dict(device="cpu", n_requests=6, batch=4, prompt_len=20, gen_len=5,
              n_pods=4, verbose=False)
    one = serve("qwen3_14b", mode="numapte", **kw)
    for mode in ("local", "eager", "numapte"):
        replicas = mode != "local"
        r = serve("qwen3_14b", mode=mode, n_pools=4, replicas=replicas,
                  check_replicas=replicas, **kw)
        np.testing.assert_array_equal(r["token_ids"], one["token_ids"])
        assert r["logits_finite"] and r["n_pools"] == 4
        assert r["replicas"] is replicas
        if not replicas:
            assert "prologue_ms" not in r
            continue
        assert r["replica_mismatches"] == 0
        assert r["prologue_calls"] >= 2 * 5     # one a decode step, and more
        # eager gathers the four 13-byte mutation buffers every step; numaPTE
        # that too, plus its misses, their windows and the sharer bits
        floor = 4 * 3 * 1024 * 13
        assert r["wire_bytes_per_step"] >= floor
        if mode == "numapte":
            assert r["fetches"] > 0


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)


def test_torch_train_step_matches_reference_without_pods():
    jcfg, tcfg, jparams, tparams = _setup("yi_6b", "f32")
    tokens = _batch(jcfg, 4, 16)
    jstep = jspecs.build_train_step(jcfg)
    jp, jopt, jm_ = jstep(jparams, joptim.adamw_init(jparams),
                          {"tokens": jnp.asarray(tokens)})
    p, opt, m = specs.build_train_step(tcfg)(
        tparams, adamw_init(tparams), {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm_["grad_norm"]),
                               rtol=1e-4)
    assert int(opt.step) == int(jopt.step) == 1
    # a first Adam step moves each parameter by at most lr (1 + decay * |p|)
    # either way, so this holds the step's direction to that bound
    lr = float(cosine_lr(torch.tensor(1)))
    want = tm.params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    for got, w in zip(tree_leaves(p), tree_leaves(want)):
        assert (got - w).abs().max() <= 2 * lr * 1.01


def _fused_mean(terms, n):
    """The pods' int8 mean, written independently of the pod leg: each
    dequantized term added in order with one float32 rounding (float64
    arithmetic), then divided by n."""
    acc = None
    for q, sc in terms:
        t = q.double() * sc.double()
        acc = (t if acc is None else t + acc.double()).float()
    return acc / n


def _within_ulp(got, want):
    big = torch.maximum(got.abs(), want.abs())
    up = torch.nextafter(big, torch.full_like(big, float("inf")))
    return (got - want).abs() <= up - big


def test_torch_train_step_over_pods_float32_and_int8_legs():
    """Two loop pods, two sequences each.  float32 leg: the loss is the
    full batch's.  int8 leg from the same start: its averaged gradients
    (the first step's and a second fed the first's error buffers) equal an
    independent mean of dequant(quant(g_i + e_i)) over the pods' own
    gradients within 1 ulp, and the mean without the last pod's term does
    not; the int8 average lies within the pods' mean half scale step of the
    float32 one; each error buffer is exactly g - dequant(quant(g)); and the
    step's parameters are AdamW's on that average, bit for bit."""
    _, tcfg, _, tparams = _setup("yi_6b", "f32")
    tokens = torch.from_numpy(_batch(tcfg, 4, 16, seed=1))
    pods = LoopPods(2, "cpu")
    fresh = lambda: _setup("yi_6b", "f32")[3]

    _, _, full = specs.build_train_step(tcfg)(fresh(), adamw_init(tparams),
                                              {"tokens": tokens})
    _, _, m32 = specs.build_train_step(tcfg, pods=pods)(
        tparams, adamw_init(tparams), {"tokens": tokens})
    np.testing.assert_allclose(float(m32["loss"]), float(full["loss"]), rtol=1e-6)

    start = fresh()
    p8, _, m8, ef = specs.build_train_step(tcfg, compress_pod_grads=True,
                                           pods=pods)(
        fresh(), adamw_init(start), {"tokens": tokens})
    assert float(m8["loss"]) == float(m32["loss"])
    avg32, _, _ = specs.pod_gradients(tcfg, start, {"tokens": tokens}, pods)
    avg8, _, ef0 = specs.pod_gradients(tcfg, start, {"tokens": tokens}, pods,
                                       True)
    avg8b, _, _ = specs.pod_gradients(tcfg, start, {"tokens": tokens}, pods,
                                      True, ef0)
    per_pod = [specs._grads(tcfg, start, {"tokens": tokens[2 * i:2 * i + 2]})[2]
               for i in range(2)]
    for li in range(len(avg8)):
        g = [per_pod[i][li].float() for i in range(2)]
        terms = [compression.quantize_int8(t) for t in g]
        for i in range(2):
            np.testing.assert_array_equal(
                ef[li][i].numpy(),
                (g[i] - compression.dequantize_int8(*terms[i])).numpy())
        assert _within_ulp(avg8[li], _fused_mean(terms, 2)).all()
        assert not _within_ulp(avg8[li], _fused_mean(terms[:1], 2)).all()
        half = sum(float(sc) for _, sc in terms) / 2 / 2
        assert float((avg8[li] - avg32[li]).abs().max()) <= half * (1 + 1e-3)
        second = [compression.quantize_int8(g[i] + ef0[li][i]) for i in range(2)]
        assert _within_ulp(avg8b[li], _fused_mean(second, 2)).all()
    replay, _, _ = adamw_update(start, avg8, adamw_init(start))
    for a, b in zip(tree_leaves(replay), tree_leaves(p8)):
        assert torch.equal(a, b)
