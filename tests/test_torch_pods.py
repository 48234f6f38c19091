"""The pod axis (``repro_torch.distributed.pods``): ``LoopPods`` against the
``lax`` collectives the reference's bodies call, run under
``jax.vmap(..., axis_name="pod")``; its wire-byte count; and ``DistPods``
over gloo at world size 2 (two spawned processes), which must give what
``LoopPods(2)`` gives for the coherence prologues, the int8 pod leg and SP
decode.  ``DistPods`` is verified on gloo only: NCCL refuses two ranks on
one GPU."""
from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro_torch.distributed import LoopPods  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("P", [1, 2, 4])
def test_torch_loop_pods_match_lax_collectives(P):
    rng = np.random.default_rng(P)
    x = rng.standard_normal((P, 3, 5)).astype(np.float32)
    routed = rng.standard_normal((P, P, 3)).astype(np.float32)

    def body(x, r):
        return (lax.axis_index("pod"), lax.all_gather(x, "pod"),
                lax.all_to_all(r, "pod", 0, 0, tiled=False),
                lax.psum(x, "pod"), lax.pmax(x, "pod"))

    want = jax.vmap(body, axis_name="pod")(jnp.asarray(x), jnp.asarray(routed))
    pods = LoopPods(P, "cpu")
    got = (pods.index(), pods.all_gather(torch.from_numpy(x)),
           pods.all_to_all(torch.from_numpy(routed)),
           pods.psum(torch.from_numpy(x)), pods.pmax(torch.from_numpy(x)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w.reshape(g.shape), rtol=1e-6)
    # each pod receives the other pods' slices: x's 60 bytes a pod for the
    # gather and each reduction, routed's 12-byte chunks for the all-to-all
    assert pods.wire_bytes == P * (P - 1) * (3 * 60 + 12)
    assert pods.calls == {"all_gather": 1, "all_to_all": 1, "psum": 1, "pmax": 1}
    pods.reset_counters()
    assert pods.wire_bytes == 0 and pods.calls == {}


def test_torch_pod_axis_checks_shapes_and_mesh_builds_it():
    pods = mesh.make_debug_mesh(3, device="cpu")
    assert isinstance(pods, LoopPods) and pods.n == pods.local == 3
    with pytest.raises(ValueError):
        pods.all_gather(torch.zeros(2, 4))
    with pytest.raises(ValueError):
        pods.all_to_all(torch.zeros(3, 2))
    with pytest.raises(RuntimeError):      # no process group here
        mesh.make_production_mesh(device="cpu")


def test_torch_production_mesh_defaults_to_the_card(tmp_path):
    """With no device the production pods take the rank's GPU: on a machine
    without one they raise, even inside a process group, and never build
    CPU pods on their own."""
    import torch.distributed as dist
    from repro_torch.distributed import DistPods
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        if torch.cuda.is_available():
            assert mesh.make_production_mesh().device.type == "cuda"
        else:
            for build in (mesh.make_production_mesh, DistPods):
                with pytest.raises(RuntimeError, match="none is available"):
                    build()
        pods = mesh.make_production_mesh(device="cpu")
        assert pods.device == torch.device("cpu") and pods.n == 1
    finally:
        dist.destroy_process_group()


WORKER = r'''
import sys, numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.distributed import compress_allreduce_pods
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.kvcache import gather as tg
from repro_torch.pagedpt import coherence as coh

T, EPB, B, M, P = 8, 32, 12, 5, 2


def inputs():
    rng = np.random.default_rng(0)
    e = (rng.integers(0, 1 << 20, (P, T, EPB)) | (3 << 28)).astype(np.int32)
    e[rng.random(e.shape) < 0.4] = -1
    slots = rng.permutation(T * EPB - 1)[:P * B].reshape(P, B)
    muts = [(slots // EPB).astype(np.int32), (slots % EPB).astype(np.int32),
            rng.integers(-1, 1 << 20, (P, B)).astype(np.int32),
            rng.random((P, B)) > 0.3]
    sharers = rng.integers(0, 1 << P, T).astype(np.int64)
    owner = rng.integers(0, P, T).astype(np.int32)
    miss = rng.integers(-1, T * EPB, (P, M)).astype(np.int32)
    grads = [rng.standard_normal((P, 6, 4)).astype(np.float32),
             rng.standard_normal((P, 3)).astype(np.float32)]
    n, MB, F, bt, K, hd = P, 4, 6, 4, 2, 16
    sp = dict(q=rng.standard_normal((2, 4, hd)).astype(np.float32),
              ks=rng.standard_normal((n, F, bt, K, hd)).astype(np.float32),
              vs=rng.standard_normal((n, F, bt, K, hd)).astype(np.float32),
              kn=rng.standard_normal((2, K, hd)).astype(np.float32),
              vn=rng.standard_normal((2, K, hd)).astype(np.float32),
              tables=np.array([[0, 1, 0, 1], [2, -1, -1, -1]], np.int32),
              lens=np.array([14, 3], np.int32))
    return e, muts, sharers, owner, miss, grads, sp


def run(pods, sl):
    """Every pod-axis function on the pods ``sl`` of the stacked inputs."""
    e, muts, sharers, owner, miss, grads, sp = inputs()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[sl]))
    m = [t(a) for a in muts]
    eager = coh.eager_sync(t(e), *m, pods=pods)
    rep, sh = coh.numapte_prologue(t(e), torch.from_numpy(sharers),
                                   torch.from_numpy(owner), *m, t(miss), 2, pods)
    avg, ef = compress_allreduce_pods([t(g) for g in grads], None, pods)
    T_ = lambda a: torch.from_numpy(a)
    out, ks, _ = tg.decode_attention_sp(
        T_(sp["q"]), t(sp["ks"]), t(sp["vs"]), T_(sp["kn"]), T_(sp["vn"]),
        T_(sp["tables"]), T_(sp["lens"] - 1), T_(sp["lens"]), block_tokens=4,
        n_kv=2, pods=pods)
    return dict(eager=eager, rep=rep, sharers=sh[None], avg0=avg[0][:1].clone(),
                avg1=avg[1][:1].clone(), ef0=ef[0], ef1=ef[1], sp=out[None],
                ks=ks, wire=torch.tensor([pods.wire_bytes]))


def worker(rank, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=P, rank=rank)
    got = run(make_production_mesh(device="cpu"), slice(rank, rank + 1))
    np.savez(f"{out_dir}/rank{rank}.npz", **{k: v.numpy() for k, v in got.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
    out_dir = sys.argv[1]
    mp.spawn(worker, args=(port, out_dir), nprocs=P)
    results = {r: dict(np.load(f"{out_dir}/rank{r}.npz")) for r in range(P)}
    want = {k: v.numpy() for k, v in run(make_debug_mesh(P, device="cpu"),
                                         slice(0, P)).items()}
    for k, w in want.items():
        for r in range(P):
            g = results[r][k]
            if k in ("sharers", "avg0", "avg1", "sp", "wire"):
                w_r = w[:1]                     # replicated: any pod's
            else:
                w_r = w[r:r + 1]
            assert np.array_equal(g, w_r), (k, r, g, w_r)
    print("equal", sorted(want))
'''


def test_torch_dist_pods_on_gloo_equal_loop_pods(tmp_path):
    script = tmp_path / "dist_pods_worker.py"
    script.write_text(WORKER)
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True,
                         text=True, timeout=60, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "",
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("equal"), out.stdout
