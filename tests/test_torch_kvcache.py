"""KV slab writes of the port: padding rows are inert, and the in-place
PyTorch functions store what the JAX functions return, on the same inputs."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kvcache import gather as jg  # noqa: E402
from repro_torch.kvcache.gather import (gather_readonly,  # noqa: E402
                                        scatter_prefill_plain,
                                        write_token_plain)

F, BT, K, HD, B = 6, 4, 2, 8, 3


def _slabs(rng):
    k = rng.normal(size=(F, BT, K, HD)).astype(np.float32)
    v = rng.normal(size=(F, BT, K, HD)).astype(np.float32)
    return k, v


def test_torch_padding_rows_never_write_device_kv():
    """test_padding_rows_never_write_device_kv, on the port: rows whose
    block is unmapped (-1) leave the slabs byte-identical."""
    rng = np.random.default_rng(0)
    k_np, v_np = _slabs(rng)
    k_slabs, v_slabs = torch.from_numpy(k_np.copy()), torch.from_numpy(v_np.copy())
    k_new = torch.from_numpy(rng.normal(size=(B, K, HD)).astype(np.float32))
    v_new = torch.from_numpy(rng.normal(size=(B, K, HD)).astype(np.float32))
    # row 0 live in frame 2; rows 1-2 are padding (all -1 tables)
    phys = torch.tensor([[2, 3], [-1, -1], [-1, -1]], dtype=torch.int32)
    pos = torch.zeros((B,), dtype=torch.int32)
    k2, v2 = write_token_plain(k_slabs, v_slabs, k_new, v_new, phys, pos, BT)
    assert k2 is k_slabs and v2 is v_slabs                 # in place
    assert torch.equal(k2[2, 0], k_new[0]) and torch.equal(v2[2, 0], v_new[0])
    want_k, want_v = k_np.copy(), v_np.copy()
    want_k[2, 0], want_v[2, 0] = k_new[0].numpy(), v_new[0].numpy()
    np.testing.assert_array_equal(k2.numpy(), want_k)      # nothing else moved
    np.testing.assert_array_equal(v2.numpy(), want_v)

    # prefill scatter: padding tokens are dropped, not clamped to frame 0
    S = 4
    k_slabs, v_slabs = torch.from_numpy(k_np.copy()), torch.from_numpy(v_np.copy())
    kp = torch.from_numpy(rng.normal(size=(B, S, K, HD)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(B, S, K, HD)).astype(np.float32))
    pos2 = torch.arange(S, dtype=torch.int32).repeat(B, 1)
    scatter_prefill_plain(k_slabs, v_slabs, kp, vp, phys, pos2, BT)
    want_k, want_v = k_np.copy(), v_np.copy()
    want_k[2], want_v[2] = kp[0].numpy(), vp[0].numpy()
    np.testing.assert_array_equal(k_slabs.numpy(), want_k)
    np.testing.assert_array_equal(v_slabs.numpy(), want_v)


def test_torch_all_padding_batch_writes_nothing():
    """The warm-up calls of serve(): every row is padding."""
    rng = np.random.default_rng(1)
    k_np, v_np = _slabs(rng)
    k_slabs, v_slabs = torch.from_numpy(k_np.copy()), torch.from_numpy(v_np.copy())
    phys = torch.full((B, 2), -1, dtype=torch.int32)
    new = torch.ones((B, K, HD))
    write_token_plain(k_slabs, v_slabs, new, new, phys,
                      torch.tensor([0, 5, 3], dtype=torch.int32), BT)
    scatter_prefill_plain(k_slabs, v_slabs, torch.ones((B, 5, K, HD)),
                          torch.ones((B, 5, K, HD)), phys,
                          torch.arange(5, dtype=torch.int32).repeat(B, 1), BT)
    np.testing.assert_array_equal(k_slabs.numpy(), k_np)
    np.testing.assert_array_equal(v_slabs.numpy(), v_np)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_token_write_and_scatter_match_jax(dtype):
    """Live and padding rows mixed, a padding row aimed at a slot a live row
    writes (frame 0), positions past the first block."""
    rng = np.random.default_rng(2)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    k_np, v_np = _slabs(rng)
    phys_np = np.array([[0, 3], [-1, -1], [4, 1], [-1, 2]], np.int32)
    pos_np = np.array([0, 0, 5, 1], np.int32)              # row 3: block 0 absent
    n = phys_np.shape[0]
    kn = rng.normal(size=(n, K, HD)).astype(np.float32)
    vn = rng.normal(size=(n, K, HD)).astype(np.float32)
    jk, jv, k_all, v_all = jg.update_gather_plain(
        jnp.asarray(k_np, jd), jnp.asarray(v_np, jd), jnp.asarray(kn, jd),
        jnp.asarray(vn, jd), jnp.asarray(phys_np), jnp.asarray(pos_np), BT)
    tk, tv = torch.from_numpy(k_np.copy()).to(td), torch.from_numpy(v_np.copy()).to(td)
    write_token_plain(tk, tv, torch.from_numpy(kn).to(td), torch.from_numpy(vn).to(td),
                      torch.from_numpy(phys_np), torch.from_numpy(pos_np), BT)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))

    # the gathered copy the plain attention reads
    gk, gv = gather_readonly(tk[None], tv[None], 0, torch.from_numpy(phys_np))
    np.testing.assert_array_equal(gk.float().numpy(), np.asarray(k_all, np.float32))
    np.testing.assert_array_equal(gv.float().numpy(), np.asarray(v_all, np.float32))

    S = 7
    kp = rng.normal(size=(n, S, K, HD)).astype(np.float32)
    vp = rng.normal(size=(n, S, K, HD)).astype(np.float32)
    pos2 = np.tile(np.arange(S, dtype=np.int32), (n, 1))
    jk, jv = jg.scatter_prefill_plain(
        jnp.asarray(k_np, jd), jnp.asarray(v_np, jd), jnp.asarray(kp, jd),
        jnp.asarray(vp, jd), jnp.asarray(phys_np), jnp.asarray(pos2), BT)
    tk, tv = torch.from_numpy(k_np.copy()).to(td), torch.from_numpy(v_np.copy()).to(td)
    scatter_prefill_plain(tk, tv, torch.from_numpy(kp).to(td),
                          torch.from_numpy(vp).to(td), torch.from_numpy(phys_np),
                          torch.from_numpy(pos2), BT)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
