"""Phase ``numa_sim``: the NUMA simulator (``repro_torch.core``, host
protocol in numpy) with pass 1 of its batch engine on the fifo_miss kernel:
fig08's five apps x three policies at its full settings with --scale 16
(PAPER_8SOCKET, 40 000 accesses a thread, 4 096 pages a GB, degree-9
prefetch, engine "batch": 8 kernel launches a run), and the closed serving
loop (``repro_torch.serving``, every serving policy on one Poisson trace),
each with REPRO_FIFO_MISS_BACKEND set to cuda and to numpy: the results must
be identical, and fifo_miss must launch once an engine call and no other
kernel run.  Before that, the kernel against its plain version and the numpy
loop, bit for bit, at the reference's 25 trials, 200 streams over a handful
of vpns (ids repeating inside the kernel's windows of 32, capacities 0-4),
adversarial streams (one vpn 32 times, capacities 0, 1, 31, 32, 33, every
length mod 32, windows that take 19 and 33 rounds), every engine call of the
run through the engine's own ids (``dense``), the largest engine call (the
fill vector in shared memory) and a stream of 2^24 accesses over 2^20 vpns
(in global memory); timed beside the whole cuda backend call, the numpy
loop, its byte bound and a one-step-at-a-time floor, with the walk's rounds
a window.
"""
import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import (APPS, batch as sim_batch, PAPER_8SOCKET, Policy, run_app,
                              SimConfig)
from repro_torch.kernels import _build
from repro_torch.kernels.fifo_miss import (densify, fifo_miss, fifo_miss_ids,
                                           fifo_miss_ref, ops as fifo_ops)
from repro_torch.launch.analysis import HBM_BW
from repro_torch.serving import (nominal_capacity_rps, poisson_trace, run_closed_loop,
                                 SERVING_POLICIES)
from .common import (check, counts_now, DEV, emit, reset_counters, ROOT, time_ms,
                     uncapped)


# fig08_apps at its full settings with --scale 16 (benchmarks/fig08_apps.py):
# the 8-socket machine, 40 000 accesses a thread, 4 096 pages a GB, every
# page touched, degree-9 prefetch, the batch engine (8 fifo_miss calls a run)
NUMA_APP = dict(accesses_per_thread=40_000, pages_per_gb=4_096, touch_stride=1)
NUMA_APPS = tuple(sorted(APPS))
NUMA_POLICIES = (Policy.LINUX, Policy.MITOSIS, Policy.NUMAPTE)
# the global-memory path: a stream of 2^24 accesses over 2^20 vpns, whose
# fill vector (4 MB) does not fit a block's shared memory
FIFO_LONG = dict(n=1 << 24, distinct=1 << 20, capacity=1088)
# the closed serving loop: one Poisson trace at 0.9 of nominal capacity
CLOSED_LOOP = dict(n_requests=256, load=0.9, seed=0)
# A one-step-at-a-time floor, kept beside the byte bound for comparison with
# the first design: it assumed a walk that takes one access at a time, each
# step at least one dependent integer compare and one add, at an assumed 4
# cycles each (not measured here), at the card's maximum SM clock.  The warp
# walk settles 32 accesses a round and is not bound by it; ``bound_ms`` (the
# bytes) is the row's bound.
CHAIN_CYCLES = 8


def fifo_trials():
    """The reference's 25 random streams, capacities and warm TLBs
    (tests/test_trace_differential.py)."""
    rng = np.random.default_rng(2024)
    for _ in range(25):
        cap = int(rng.integers(1, 64))
        n0 = int(rng.integers(0, cap + 1))
        init = rng.permutation(500)[:n0].astype(np.int64).tolist()
        arr = rng.integers(0, 1 + int(rng.integers(1, 120)),
                           size=int(rng.integers(0, 300))).astype(np.int64)
        yield arr, init, cap


def fifo_repeats():
    """Streams over a handful of vpns at capacities 0-4: ids repeat inside
    the kernel's windows of 32, and lengths leave every remainder."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        cap = int(rng.integers(0, 5))
        init = rng.permutation(10)[:int(rng.integers(0, cap + 1))].tolist()
        arr = rng.integers(0, int(rng.integers(1, 7)),
                           size=int(rng.integers(0, 41))).astype(np.int64)
        yield arr, init, cap


def fifo_adversarial():
    """Streams aimed at the warp walk (tests/test_torch_fifo_window.py):
    one vpn 32 times, capacities around the window's width, every length
    mod 32, and two windows that need many rounds: a cold vpn then a sweep
    of the oldest entries of a full TLB (33 rounds), and a window over three
    vpns with peers on every lane (19)."""
    for cap in (0, 1, 2, 31, 32, 33):
        for init in ([], [7], [3, 7, 9][:max(cap, 1)]):
            yield [7] * 37, init, cap
    rng = np.random.default_rng(100)
    for cap in (0, 1, 31, 32, 33):
        for _ in range(12):
            alphabet = int(rng.choice([2, 5, 40, 100, 1000]))
            init = rng.permutation(alphabet + 50)[:int(rng.integers(0, cap + 1))]
            yield (rng.integers(0, alphabet, int(rng.integers(1, 400))),
                   init.tolist(), cap)
    for r in range(32):
        yield rng.integers(0, 60, 96 + r), rng.permutation(60)[:20].tolist(), 24
    init = list(range(1000, 1040))
    yield [init[-1]] * 32 + [5] + init[:31], init, 40
    yield ([0, 2, 2, 0, 2, 1, 0, 2, 1, 0, 0, 1, 2, 0, 1, 1,
            0, 1, 0, 1, 2, 1, 2, 0, 0, 1, 1, 2, 0, 0, 0, 2], [1], 2)


def fifo_long_stream():
    rng = np.random.default_rng(1)
    n, u = FIFO_LONG["n"], FIFO_LONG["distinct"]
    arr = rng.integers(0, u, n)
    arr[:u] = rng.permutation(u)          # every one of the u vpns appears
    rng.shuffle(arr)
    init = rng.permutation(u)[:FIFO_LONG["capacity"]].tolist()
    return (1 << 20) + 7 * arr, [(1 << 20) + 7 * v for v in init], \
        FIFO_LONG["capacity"]


def fifo_rounds(fill0: torch.Tensor, n0: int, ids: torch.Tensor,
                cap: int) -> int:
    """The warp walk's rounds over all its windows on one stream (the
    launch's diagnostic output; the wrapper passes none, so this launch is
    not counted)."""
    U = fill0.numel()
    mask = torch.empty(ids.numel(), dtype=torch.uint8, device=DEV)
    rounds = torch.zeros(1, dtype=torch.int32, device=DEV)
    scratch = (None if U <= fifo_ops._shared_ids(DEV.index)
               else torch.empty(U, dtype=torch.int32, device=DEV))
    code = fifo_ops._launcher()(
        fill0.data_ptr(), U, n0, ids.data_ptr(), ids.numel(), cap,
        None if scratch is None else scratch.data_ptr(), mask.data_ptr(),
        rounds.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("fifo_miss", code)
    return int(rounds.item())


def fifo_check(arr, init, cap) -> dict:
    """Kernel, plain version and numpy loop on one stream, bit for bit: the
    kernel over ``densify``'s ids, and the whole ``"cuda"`` backend call
    through the stream's own ids (``dense``, as the batch engine passes
    them); the seed fill vector stays as it was.  Returns the number of
    flags that differ, the walls of the plain version and of the numpy loop
    on this stream, and the walk's rounds."""
    arr = np.asarray(arr, np.int64)
    fill0, n0, ids = densify(arr, init, cap)
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    got = fifo_miss_ids(f, n0, i, cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fifo_miss_ref(f, n0, i, cap)
    t1 = time.perf_counter()
    loop = fifo_miss(arr, init, cap, backend="numpy")
    t2 = time.perf_counter()
    dense = fifo_miss(arr, init, cap, backend="cuda",
                      dense=np.unique(arr, return_inverse=True))
    err = max(int((got != want).sum()), int((got.cpu().numpy() != loop).sum()),
              int((dense != loop).sum()))
    check(err == 0 and got.shape == (len(arr),) and got.dtype == torch.bool
          and dense.shape == (len(arr),) and dense.dtype == bool,
          f"fifo_miss: {err} flags differ (n {len(arr)}, U {fill0.size}, "
          f"capacity {cap})")
    check(np.array_equal(f.cpu().numpy(), fill0), "fifo_miss wrote its seed")
    rounds = fifo_rounds(f, n0, i, cap) if len(arr) else 0
    windows = -(-len(arr) // 32)
    check(windows <= rounds <= 33 * windows,
          f"fifo_miss: {rounds} rounds over {windows} windows")
    return {"max_abs_err": err, "plain_wall_ms": 1e3 * (t1 - t0),
            "numpy_wall_ms": 1e3 * (t2 - t1), "misses": int(loop.sum()),
            "windows": windows, "rounds": rounds}


def fifo_times(arr, init, cap, sm_mhz: float, iters: int) -> dict:
    """The kernel's device time, the whole ``"cuda"`` backend call's wall
    as the batch engine makes it (its ids given, staging and both copies
    included) and without them (``np.unique`` inside), the byte bound and
    the one-step-at-a-time floor at one stream."""
    arr = np.asarray(arr, np.int64)
    fill0, n0, ids = densify(arr, init, cap)
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    n, U = ids.size, fill0.size
    dense = np.unique(arr, return_inverse=True)
    walls = {"dense": [], "arr_only": []}
    for _ in range(max(iters // 2, 1)):
        for kind, kw in (("dense", {"dense": dense}), ("arr_only", {})):
            t0 = time.perf_counter()
            fifo_miss(arr, init, cap, backend="cuda", **kw)
            walls[kind].append(time.perf_counter() - t0)
    # each input read once (ids and the seed), each flag written once
    t_bytes = (4 * n + 4 * U + n) / HBM_BW
    return {"n": n, "distinct_ids": U, "capacity": cap, "tlb_entries": n0,
            "fill_vector": ("shared" if U <= fifo_ops._shared_ids(DEV.index)
                            else "global"),
            "ms": time_ms(lambda: fifo_miss_ids(f, n0, i, cap), iters=iters),
            "backend_wall_ms": 1e3 * float(np.median(walls["dense"])),
            "backend_wall_ms_arr_only": 1e3 * float(np.median(walls["arr_only"])),
            "bound_ms": 1e3 * t_bytes, "bound_by": "bytes",
            "chain_floor_ms": n * CHAIN_CYCLES / (sm_mhz * 1e3),
            "bound_used": "bytes (bound_ms); chain_floor_ms, a one-step-at-a-"
                          "time floor, beside it"}


def fifo_rejections() -> dict:
    """Arguments the kernel cannot take fail: the launch refuses a fill
    vector too large for shared memory without a scratch, and ids that are
    not 4-byte aligned, with cudaErrorInvalidValue; an id outside the fill
    vector fails the device assert before the walk (in a process of its
    own: the error ends its CUDA context)."""
    f = torch.zeros(60_000, dtype=torch.int32, device=DEV)
    ids = torch.zeros(8, dtype=torch.int32, device=DEV)
    mask = torch.empty(8, dtype=torch.uint8, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream
    launch = fifo_ops._launcher()
    too_big = launch(f.data_ptr(), 60_000, 0, ids.data_ptr(), 4, 1, None,
                     mask.data_ptr(), None, stream)
    misaligned = launch(f.data_ptr(), 16, 0, ids.data_ptr() + 2, 4, 1, None,
                        mask.data_ptr(), None, stream)
    check(too_big == 1 and misaligned == 1, f"fifo_miss launched on what it "
          f"cannot take: codes {too_big}, {misaligned}")
    prog = (
        "import sys, torch\n"
        "sys.path.insert(0, 'src')\n"
        "from repro_torch.kernels.fifo_miss import fifo_miss_ids\n"
        "i32 = dict(dtype=torch.int32, device='cuda')\n"
        "fifo_miss_ids(torch.zeros(4, **i32), 0, torch.tensor([0, 4], **i32), 2)\n"
        "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300,
                         cwd=ROOT)
    check(run.returncode != 0 and "assert" in run.stderr.lower(),
          f"an id outside the fill vector was not rejected: rc "
          f"{run.returncode}, {run.stderr[-400:]}")
    said = [ln for ln in run.stderr.splitlines() if "assert" in ln.lower()]
    return {"too_big_code": too_big, "misaligned_code": misaligned,
            "bad_id": said[0][-160:]}


@contextlib.contextmanager
def engine_calls(into: list, keep: bool = False):
    """Record the batch engine's fifo_miss calls: their sizes, and with
    ``keep`` their inputs."""
    real = sim_batch.fifo_miss

    def recorded(arr, initial, capacity, **kw):
        initial = list(initial)
        into.append((np.array(arr), initial, capacity) if keep else len(arr))
        return real(arr, initial, capacity, **kw)

    sim_batch.fifo_miss = recorded
    try:
        yield into
    finally:
        sim_batch.fifo_miss = real


def numa_sim_apps(backend: str):
    os.environ["REPRO_FIFO_MISS_BACKEND"] = backend
    out, t0 = {}, time.perf_counter()
    for app in NUMA_APPS:
        for policy in NUMA_POLICIES:
            out[f"{app}/{policy.value}"] = run_app(
                policy, APPS[app], PAPER_8SOCKET,
                config=SimConfig(prefetch_degree=9, engine="batch"), **NUMA_APP)
    return out, time.perf_counter() - t0


def numa_sim_closed_loop(backend: str):
    os.environ["REPRO_FIFO_MISS_BACKEND"] = backend
    rate = CLOSED_LOOP["load"] * nominal_capacity_rps()
    trace = poisson_trace(CLOSED_LOOP["n_requests"], rate,
                          seed=CLOSED_LOOP["seed"])
    t0 = time.perf_counter()
    rows = {p: run_closed_loop(p, arrival_rate_rps=rate,
                               n_requests=len(trace), trace=trace)
            for p in SERVING_POLICIES}
    return rows, time.perf_counter() - t0


def phase_numa_sim():
    """The module's docstring.  Returns the kernel row, the counts of the
    main path and what the path implies."""
    t_phase = time.perf_counter()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    # (b) first on numpy, recording the engine's calls for (a)
    with engine_calls([], keep=True) as recorded:
        want_apps, numpy_s = numa_sim_apps("numpy")
    check(len(recorded) == 8 * len(want_apps),
          f"{len(recorded)} fifo_miss calls in {len(want_apps)} runs, not 8 each")
    want_loop, loop_numpy_s = numa_sim_closed_loop("numpy")
    # (a) the kernel against its plain version and the numpy loop
    trials = (list(fifo_trials()) + list(fifo_repeats())
              + list(fifo_adversarial()))
    checked = [fifo_check(*case) for case in trials]
    adversarial = checked[-2:]
    check([c["rounds"] for c in adversarial] == [2 + 33, 19],
          f"fifo_miss: the constructed windows took "
          f"{[c['rounds'] for c in adversarial]} rounds, not [2 + 33, 19]")
    engine_checked = [fifo_check(*case) for case in recorded]
    engine = max(recorded, key=lambda c: np.unique(c[0]).size + len(c[1]))
    engine_walls = fifo_check(*engine)
    long = fifo_long_stream()
    long_walls = fifo_check(*long)
    err = max(c["max_abs_err"] for c in
              checked + engine_checked + [engine_walls, long_walls])
    # the main path: every count 0 before, read after
    reset_counters()
    with engine_calls([]) as sizes:
        got_apps, cuda_s = numa_sim_apps("cuda")
        got_loop, loop_cuda_s = numa_sim_closed_loop("cuda")
    torch.cuda.synchronize()
    counts = counts_now()
    os.environ.pop("REPRO_FIFO_MISS_BACKEND")
    check(got_apps == want_apps, "run_app differs between the cuda and the "
          "numpy backends: " + ", ".join(k for k in want_apps
                                          if got_apps[k] != want_apps[k]))
    check(got_loop == want_loop, "run_closed_loop differs between backends")
    launched = sum(1 for n in sizes if n > 0)
    want = uncapped({"paged_attention": 0, "flash_attention": 0,
                     "flash_attention_bwd": 0, "pte_gather": 0,
                     "fifo_miss": launched})
    check(launched == 8 * len(got_apps) and counts == want,
          f"numa_sim: launch counts {counts}, the path implies {want}")
    engine_t = fifo_times(*engine, sm_mhz=sm_mhz, iters=10)
    long_t = fifo_times(*long, sm_mhz=sm_mhz, iters=3)
    fill0, n0, ids = densify(np.asarray(engine[0], np.int64), *engine[1:])
    f, i = torch.from_numpy(fill0).to(DEV), torch.from_numpy(ids).to(DEV)
    row = {"name": "fifo_miss", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/fifo_miss.cu",
           "replaces": "src/repro/kernels/fifo_miss.py:88", "launches": 0,
           "max_abs_err": err,
           "ms": engine_t["ms"],
           "plain_ms": time_ms(lambda: fifo_miss_ref(f, n0, i, engine[2]),
                               iters=3),
           "bound_ms": engine_t["bound_ms"], "bound_by": "bytes",
           "library_ms": None,
           "numpy_wall_ms": engine_walls["numpy_wall_ms"],
           "engine_call": {**engine_t, **engine_walls},
           "long_stream": {**long_t, **long_walls},
           "cases": len(trials) + len(recorded) + 2, "tolerance": 0,
           "engine_calls_rounds_per_window": sum(
               c["rounds"] for c in engine_checked) / max(
               sum(c["windows"] for c in engine_checked), 1),
           "rejections": fifo_rejections()}
    emit({"phase": "numa_sim", "apps": list(NUMA_APPS),
          "policies": [p.value for p in NUMA_POLICIES],
          "topology": "PAPER_8SOCKET", **NUMA_APP, "prefetch_degree": 9,
          "engine": "batch", "cuts": [],
          "runs": len(got_apps), "fifo_miss_calls": len(sizes),
          "fifo_miss_launches": counts["fifo_miss"],
          "accesses_per_call_max": max(sizes),
          "apps_wall_s": {"numpy": numpy_s, "cuda": cuda_s},
          "closed_loop": {**CLOSED_LOOP, "policies": list(SERVING_POLICIES),
                          "wall_s": {"numpy": loop_numpy_s, "cuda": loop_cuda_s},
                          "p99_us": {p: r["p99_us"] for p, r in got_loop.items()}},
          "results_identical": True, "sm_clock_max_mhz": sm_mhz,
          "exec_ns": {k: r["exec_ns"] for k, r in got_apps.items()},
          "wall_s": time.perf_counter() - t_phase})
    return row, counts, want
