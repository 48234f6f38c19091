"""Plain PyTorch versions of the three kernels against the JAX package's
oracles and its Pallas kernels (interpret mode), on the same numpy inputs.

On a CPU tensor the port's wrappers take their plain versions, so these
tests go through the public wrappers with CPU tensors.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref  # noqa: E402
from repro.kernels.pte_gather.ops import pte_gather as jax_pte  # noqa: E402
from repro.kernels.pte_gather.ref import pte_gather_ref as jax_pte_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref  # noqa: E402
from repro_torch.kernels.pte_gather import pte_gather, pte_gather_ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a (jax, torch) pair of the given type."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype.is_floating_point else x.numpy()
    return np.asarray(x, np.float32) if jnp.issubdtype(x.dtype, jnp.floating) \
        else np.asarray(x)


def _tables(rng, B, MB, bt, N):
    tables = np.full((B, MB), -1, np.int32)
    lens = rng.integers(1, MB * bt, B).astype(np.int32)
    perm = rng.permutation(N)
    f = 0
    for b in range(B):
        nb = int(np.ceil(lens[b] / bt))
        tables[b, :nb] = perm[f:f + nb]
        f += nb
    return tables, lens


@pytest.mark.parametrize("B,H,K,hd,bt,MB,N,window", [
    (2, 8, 2, 64, 16, 8, 32, None),
    (3, 4, 4, 128, 16, 4, 16, None),       # MHA
    (2, 16, 2, 64, 8, 16, 48, 24),         # sliding window
    (1, 4, 1, 32, 4, 4, 8, None),          # MQA, tiny blocks
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_paged_attention_matches_jax(B, H, K, hd, bt, MB, N, window, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((B, H, hd)).astype(np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((N, bt, K, hd)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((N, bt, K, hd)).astype(np.float32), dtype)
    tables, lens = _tables(rng, B, MB, bt, N)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    got = paged_attention(tq, tk, tv, tt, tl, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    assert paged_attention.launches == 0         # CPU tensors: plain version
    tol = 5e-5 if dtype == "f32" else 3e-2       # the reference's own bounds
    oracle = jax_paged_ref(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                           window=window)
    kernel = jax_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                       window=window)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol)
    np.testing.assert_allclose(_np(got), _np(kernel), atol=tol)
    np.testing.assert_allclose(
        _np(paged_attention_ref(tq, tk, tv, tt, tl, window=window)), _np(got),
        atol=0)


def test_torch_paged_attention_dead_row_is_zero():
    """A padding row (all -1) has no live block: the kernel's answer there is
    0 (acc / max(l, 1e-30)), and so is the plain version's; stale slab
    content — even NaN — in masked slots never reaches a live row."""
    rng = np.random.default_rng(1)
    B, H, K, hd, bt, MB, N = 3, 4, 2, 16, 4, 4, 12
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    ks = torch.from_numpy(rng.standard_normal((N, bt, K, hd)).astype(np.float32))
    vs = ks.clone()
    tables = torch.tensor([[0, 1, -1, -1], [-1] * 4, [2, -1, -1, -1]], dtype=torch.int32)
    lens = torch.tensor([6, 5, 3], dtype=torch.int32)
    out = paged_attention(q, ks, vs, tables, lens)
    assert torch.equal(out[1], torch.zeros(H, hd))
    assert torch.isfinite(out).all()
    oracle = jax_paged(jnp.asarray(q.numpy()), jnp.asarray(ks.numpy()),
                       jnp.asarray(vs.numpy()), jnp.asarray(tables.numpy()),
                       jnp.asarray(lens.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=5e-5)


@pytest.mark.parametrize("B,H,K,S,hd,causal,window", [
    (2, 4, 2, 128, 64, True, None),
    (1, 8, 8, 256, 32, True, None),
    (2, 4, 1, 128, 128, True, 64),
    (1, 4, 2, 256, 64, False, None),       # encoder (bidirectional)
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_torch_flash_attention_matches_jax(B, H, K, S, hd, causal, window, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((B, H, S, hd)).astype(np.float32), dtype)
    jk, tk = _pair(rng.standard_normal((B, K, S, hd)).astype(np.float32), dtype)
    jv, tv = _pair(rng.standard_normal((B, K, S, hd)).astype(np.float32), dtype)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, hd)
    assert flash_attention.launches == 0
    tol = 1e-4 if dtype == "f32" else 3e-2       # the reference's own bounds
    np.testing.assert_allclose(
        _np(got), _np(jax_flash_ref(jq, jk, jv, causal=causal, window=window)),
        atol=tol)
    np.testing.assert_allclose(
        _np(got), _np(jax_flash(jq, jk, jv, causal=causal, window=window)),
        atol=tol)
    # the model hands the kernel transposed [B,S,heads,hd] views
    strided = flash_attention_ref(
        tq.transpose(1, 2).contiguous().transpose(1, 2), tk, tv,
        causal=causal, window=window)
    assert torch.equal(strided, got)


@pytest.mark.parametrize("T,epb,M,degree", [
    (8, 64, 16, 2), (4, 512, 32, 9), (16, 128, 7, 0), (2, 64, 5, 3),
])
def test_torch_pte_gather_matches_jax(T, epb, M, degree):
    rng = np.random.default_rng(0)
    entries = np.full((T, epb), -1, np.int32)
    mask = rng.random((T, epb)) > 0.4
    entries[mask] = (rng.integers(0, 1 << 20, mask.sum()) | (3 << 28)).astype(np.int32)
    logical = rng.integers(-2, T * epb + 2, M).astype(np.int32)   # both edges
    got = pte_gather(torch.from_numpy(entries), torch.from_numpy(logical), degree)
    assert pte_gather.launches == 0
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[2].shape == (M, 1 << degree) and got[2].dtype == torch.int32
    for other in (jax_pte_ref(jnp.asarray(entries), jnp.asarray(logical), degree),
                  jax_pte(jnp.asarray(entries), jnp.asarray(logical), degree)):
        for g, o in zip(got, other):
            np.testing.assert_array_equal(g.numpy(), np.asarray(o))
    for g, o in zip(got, pte_gather_ref(torch.from_numpy(entries),
                                        torch.from_numpy(logical), degree)):
        assert torch.equal(g, o)


@pytest.mark.parametrize("name", ["paged_attention", "flash_attention", "pte_gather"])
def test_torch_kernel_sources_exist_and_name_their_tpu_kernel(name):
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert f"src/repro/kernels/{name}/kernel.py" in src
    assert f'extern "C" int {name}_launch' in src
    assert name in _build.KERNELS


@pytest.mark.parametrize("header", ["common.cuh", "mma.cuh", "added.cuh"])
@pytest.mark.parametrize("name", ["paged_attention", "flash_attention", "pte_gather"])
def test_torch_build_target_follows_every_header(name, header, tmp_path, monkeypatch):
    """A library is named by the hash of its source and of every header in
    ``csrc/``, so editing or adding any header rebuilds every kernel."""
    import shutil

    from repro_torch.kernels import _build
    original = _build._target(name)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build._target(name) == original          # content, not path
    path = csrc / header
    path.write_text((path.read_text() if path.exists() else "") + "\n// edited\n")
    assert _build._target(name) != original
