"""The int8 error-feedback pod leg (``repro_torch.distributed.compression``)
over ``LoopPods`` against the reference's, run under ``jax.vmap(...,
axis_name="pod")`` on the same per-pod gradients: int8 payloads and scales
bit-equal, error buffers bit-equal, averaged gradients within 1 ulp."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.distributed import LoopPods  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402


def _grads(rng, P):
    """Per-pod gradient trees [P, ...]: a matrix, a vector, an all-zero leaf
    (scale floor) and a leaf with values on the half-way points of its
    int8 grid (round half to even)."""
    half = (np.arange(-6, 7) + 0.5).astype(np.float32) * 0.25
    return {"w": (rng.standard_normal((P, 12, 10)) * 1e-3).astype(np.float32),
            "b": rng.standard_normal((P, 7)).astype(np.float32),
            "zero": np.zeros((P, 5), np.float32),
            "half": np.stack([np.concatenate([half, [127 * 0.25]])] * P)
            .astype(np.float32)}


def _ulp_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("P", [2, 4])
def test_torch_quantize_int8_matches_jax(P):
    rng = np.random.default_rng(P)
    for name, g in _grads(rng, P).items():
        for x in g:
            q, s = comp.quantize_int8(torch.from_numpy(x))
            jq, js = jcomp.quantize_int8(jnp.asarray(x))
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            assert q.dtype == torch.int8
            assert s.item() == float(js), name
            np.testing.assert_array_equal(
                comp.dequantize_int8(q, s).numpy(),
                np.asarray(jcomp.dequantize_int8(jq, js)))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("P", [2, 4])
def test_torch_compress_allreduce_pods_matches_jax(P, steps):
    """``steps`` steps with the error buffers carried: each step's average
    within 1 ulp, the buffers bit-equal, wire bytes as counted."""
    rng = np.random.default_rng(10 * P + steps)
    pods = LoopPods(P, "cpu")
    ef = jef = None
    leg = jax.vmap(lambda g, e: jcomp.compress_allreduce_pods(g, e, "pod"),
                   axis_name="pod")
    for _ in range(steps):
        g = _grads(rng, P)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        avg, ef = comp.compress_allreduce_pods(tg, ef, pods)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        javg, jef = leg(jg, jef if jef is not None else jax.vmap(jcomp.ef_init)(jg))
        for k in g:
            assert avg[k].shape == tg[k].shape and ef[k].dtype == torch.float32
            for p in range(P):
                _ulp_close(avg[k][p].numpy(), javg[k][p])
                np.testing.assert_array_equal(ef[k][p].numpy(),
                                              np.asarray(jef[k][p]))
    # a leaf of n values: the n int8 payload bytes and its 4-byte scale of
    # every pod reach the P - 1 others, each step
    n = sum(v[0].size for v in g.values())
    assert pods.wire_bytes == steps * P * (P - 1) * (n + 4 * len(g))
    assert comp.compression_wire_bytes({k: v[0] for k, v in tg.items()}) == \
        jcomp.compression_wire_bytes({k: jnp.asarray(v[0]) for k, v in g.items()})


def test_torch_error_feedback_is_the_residual():
    """e = g - dequant(quant(g)) for each pod at the first step, and the
    average is the mean of what the pods sent."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(_grads(rng, 4)["w"])
    avg, ef = comp.compress_allreduce_pods([g], None, LoopPods(4, "cpu"))
    sent = []
    for p in range(4):
        q, s = comp.quantize_int8(g[p])
        sent.append(comp.dequantize_int8(q, s))
        np.testing.assert_array_equal(ef[0][p].numpy(), (g[p] - sent[-1]).numpy())
        assert (ef[0][p].abs() <= s / 2 * (1 + 1e-6)).all()
    exact = (sum(x.double() for x in sent) / 4).numpy()
    terms = max(float(x.abs().max()) for x in sent)
    np.testing.assert_allclose(avg[0][0].numpy(), exact, rtol=0,
                               atol=4 * np.spacing(np.float32(terms)))
