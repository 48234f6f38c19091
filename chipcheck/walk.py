"""The page walk (K3) in the ``kernels`` phase: checked with the serving
path's mutation lists (a wave's allocations, a wave switch, an entry not
applied), bit-exact, the updated table included; through the manager with
lists that outgrow its first staging buffer; on arguments it must refuse;
each kind of walk (a wave's first walk, an extension step, a steady step,
the sync after the frees) one kernel and one copy (``torch.profiler``).
K3 in its three coherence roles (eager's gathered drain, numaPTE's
sharer-filtered drain, the owners' window walk and the install of the
fetched windows) at the serving geometry (64 tables x 512, 4 pods),
bit-exact against the plain coherence functions on the CPU, with its
launches a role and their byte bound.
"""
import subprocess
import sys

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.distributed import LoopPods
from repro_torch.kernels.pte_gather import pte_gather
from repro_torch.kvcache import PagedKVManager
from repro_torch.launch import specs
from repro_torch.launch.analysis import HBM_BW
from repro_torch.pagedpt import coherence
from repro_torch.pagedpt.blocktable import apply_mutations, CoherenceMode
from .common import check, DEV, plain_versions, RNG, ROOT, time_ms


def walk_args(entries, logical, degree, mutations=None):
    """Args (entries, logical, degree, mutations) of the walk on the card;
    mutations None or (table, idx, value [n] int32, applied [n] bool)."""
    if mutations is not None:
        mutations = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
                          for a in mutations)
    return (torch.from_numpy(entries).to(DEV),
            torch.from_numpy(np.asarray(logical, np.int32)).to(DEV),
            degree, mutations), {}


def pte_case(T, epb, M, degree, logical=None, mutations=None):
    entries = np.full((T, epb), -1, np.int32)
    mask = RNG.random((T, epb)) > 0.4
    entries[mask] = (RNG.integers(0, 1 << 20, mask.sum()) | (3 << 28)).astype(np.int32)
    if logical is None:
        logical = RNG.integers(-2, T * epb + 2, M)
    return walk_args(entries, logical, degree, mutations)


def pte_checked(fn):
    """Run the walk on a copy of the table and return the updated table
    beside the outputs, so kernel and plain version start from one table."""
    def run(entries, logical, degree, mutations=None):
        table = entries.clone()
        return (*fn(table, logical, degree, mutations), table)
    return run


def pte_mutations_random(T, epb, n, n_slots):
    """n mutations over the first n_slots slots (many duplicates, across the
    kernel's 1 024-mutation chunks), a quarter not applied."""
    slots = RNG.integers(0, n_slots, n)
    value = (RNG.integers(0, 1 << 20, n) | (3 << 28)).astype(np.int32)
    value[RNG.random(n) < 0.3] = -1
    return ((slots // epb).astype(np.int32), (slots % epb).astype(np.int32),
            value, RNG.random(n) > 0.25)


def drain_all(host):
    """Every pending drain of a host manager, concatenated in order, as
    ``PagedKVManager`` stages them for one walk (kept here rather than taken
    from the manager, so that ``tools/walk_compare.py`` can drive a checkout
    from before the fused walk with the same inputs)."""
    drains = []
    while True:
        table, idx, value, valid = host.drain_mutation_buffer()
        n = int(valid.sum())
        if n == 0:
            return [np.concatenate(c) for c in zip(*drains)]
        drains.append((table[:n], idx[:n], value[:n], valid[:n]))


# the serving path's page walks (Qwen3-14B served at batch 16, prompt 1024 +
# 64 generated, 4 pods, numaPTE), as serve() sizes its manager
WALK_SHAPE = dict(n_frames=16 * 69 * 4, block_tokens=16, max_blocks_per_seq=69,
                  n_pods=4, mode=CoherenceMode.NUMAPTE)


def serving_walk_cases():
    """The page walk's inputs on the serving path (Qwen3-14B served at batch
    16, prompt 1024 + 64 generated, 4 pods, numaPTE: 4 416 frames, tables of
    69 columns, 64 table pages of 512 entries, d = 3): a wave's first walk
    with its 1 024 allocations; a wave switch, the 1 088 frees of one wave
    followed by the next wave's 1 024 allocations, which reuse the freed
    slots, so that duplicates cross drains; the same with one entry not
    applied that names a live slot."""
    kv = PagedKVManager(**WALK_SHAPE, device=DEV)
    host, d = kv.host, kv.spec.prefetch_degree
    ids = list(range(16))
    empty = host.canonical.copy()
    for i in ids:
        kv.start_sequence(i, 1024, pod=i % 4)
    allocs = drain_all(host)
    first = walk_args(empty, kv.logical_tables(ids).reshape(-1), d, allocs)
    for i in ids:
        kv.maybe_extend(i, 1024 + 64)
    drain_all(host)
    before = host.canonical.copy()
    for i in ids:
        kv.finish_sequence(i)
    ids = list(range(16, 32))
    for i in ids:
        kv.start_sequence(i, 1024, pod=i % 4)
    switch = drain_all(host)
    logical = kv.logical_tables(ids).reshape(-1)
    check(len(allocs[0]) == 1024 and len(switch[0]) == 1088 + 1024,
          f"mutations {len(allocs[0])}, {len(switch[0])}")
    check(len(np.unique(switch[0] * 512 + switch[1])) < len(switch[0]),
          "the wave switch names no slot twice")
    live = int(np.flatnonzero(logical >= 0)[0])
    masked = [np.append(c, np.array(x, c.dtype)) for c, x in zip(
        switch, (logical[live] // 512, logical[live] % 512, 12345, False))]
    return {"first_walk": first,
            "wave_switch": walk_args(before, logical, d, switch),
            "masked_live_slot": walk_args(before, logical, d, masked)}


def pte_bound(args, kw):
    entries, logical, degree, mutations = args
    M, W = logical.numel(), 1 << degree
    # in: the id and the W entries of its window; out: frame, flag, window
    nbytes = M * (4 + 4 * W + 4 + 1 + 4 * W)
    if mutations is not None:
        table, idx, _, applied = mutations
        # 13 bytes a mutation read, 4 written for each slot an applied one names
        slots = (table.long() * entries.shape[1] + idx.long())[applied]
        nbytes += 13 * table.numel() + 4 * int(slots.unique().numel())
    return nbytes / HBM_BW, 0.0


def pte_library(args, kw):
    """Yardstick only (the port never calls it): the port's PyTorch
    ``apply_mutations`` where there is a list, then the window as one tensor
    indexing call (the walk's own entry is a column of it)."""
    entries, logical, degree, mutations = args
    if mutations is not None:
        apply_mutations(entries, *mutations)
    T, epb = entries.shape
    W = 1 << degree
    lg = logical.long()
    tid = (lg // epb).clamp(0, T - 1)
    start = (lg % epb - W // 2).clamp(0, epb - W)
    cols = start[:, None] + torch.arange(W, device=DEV)[None, :]
    return entries[tid[:, None], cols]


def pte_rejections():
    """Arguments the kernel cannot take fail: the launch refuses a window
    wider than a page with cudaErrorInvalidValue (whatever the wrapper
    checks), and a mutation naming a slot outside the table fails a device
    assert (in a process of its own: the error ends its CUDA context)."""
    from repro_torch.kernels.pte_gather import ops
    e = torch.full((4, 64), -1, dtype=torch.int32, device=DEV)
    out = torch.empty((4, 128), dtype=torch.int32, device=DEV)
    code = ops._launcher()(e.data_ptr(), e.data_ptr(), None, None, None, None,
                           out.data_ptr(), out.data_ptr(), out.data_ptr(),
                           4, 64, 128, 4, 0, torch.cuda.current_stream().cuda_stream)
    check(code == 1, f"a 128-wide window on 64-entry pages launched: {code}")
    prog = (
        "import sys, torch\n"
        "sys.path.insert(0, 'src')\n"
        "from repro_torch.kernels.pte_gather import pte_gather\n"
        "i32 = dict(dtype=torch.int32, device='cuda')\n"
        "m = (torch.tensor([0, 4], **i32), torch.tensor([1, 0], **i32),\n"
        "     torch.tensor([5, 6], **i32), torch.tensor([True, True], device='cuda'))\n"
        "pte_gather(torch.full((4, 64), -1, **i32), torch.zeros(2, **i32), 0, m)\n"
        "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300,
                         cwd=ROOT)
    check(run.returncode != 0 and "assert" in run.stderr.lower(),
          f"a slot outside the table was not rejected: rc {run.returncode}, "
          f"{run.stderr[-400:]}")
    said = [ln for ln in run.stderr.splitlines() if "assert" in ln.lower()]
    return {"bad_window_code": code, "bad_slot": said[0][-160:]}


def walk_staging_growth():
    """Walks whose mutation lists are longer than the manager's first staging
    buffer holds: the buffer grows, and the kernel path gives the plain
    path's frames and device table, which equals the host's."""
    def run():
        kv = PagedKVManager(n_frames=8192, block_tokens=16,
                            max_blocks_per_seq=2048, n_pods=1, device=DEV)
        first = kv._staging.buffers[0].numel()
        for sid in range(3):
            kv.start_sequence(sid, 16 * 2000, pod=0)
        n = len(kv.host._pending_mut)
        frames = [kv.physical_tables([0, 1, 2], record=False)]
        kv.finish_sequence(1)
        kv.start_sequence(3, 16 * 1500, pod=0)   # reuses sequence 1's slots
        frames.append(kv.physical_tables([0, 2, 3], record=False))
        return kv, first, n, frames

    kv, first, n, got = run()
    with plain_versions():
        plain, _, _, want = run()
    grown = max(b.numel() for b in kv._staging.buffers)
    check(13 * n > first and grown >= 13 * n,
          f"{n} mutations, first buffer {first} B, largest {grown} B")
    check(all(torch.equal(a, b) for a, b in zip(got, want))
          and torch.equal(kv.device_table, plain.device_table),
          "staged walk: kernel path and plain path differ")
    kv.check_device_table()
    return {"mutations": n, "first_buffer_bytes": first, "grown_to_bytes": grown}


def walk_wave(kv, ids, record, call, prompt_len=1024, gen_len=64):
    """One wave of the serving path's page walks, each through
    ``call(kind, fn)``: ``first`` (the wave's first walk, its 1 024
    allocations pending), ``extend`` (a decode step with extensions
    pending), ``steady`` (a decode step with none) and ``check`` (the sync of
    ``check_device_table`` after the wave's frees).  ``record`` is the
    walks' ``record`` flag."""
    for i, sid in enumerate(ids):
        kv.start_sequence(sid, prompt_len, pod=i % 4)
    call("first", lambda: kv.physical_tables(ids, record=record))
    for t in range(gen_len):
        for sid in ids:
            kv.maybe_extend(sid, prompt_len + t + 1)
        kind = "extend" if kv.host._pending_mut else "steady"
        call(kind, lambda: kv.physical_tables(ids, record=record))
    for sid in ids:
        kv.finish_sequence(sid)
    call("check", kv.sync_device_table)
    kv.check_device_table()


def walk_device_ops():
    """Device operations (kernels and copies, by name) of one walk of each
    kind, from ``torch.profiler`` around that call alone."""
    from torch.profiler import ProfilerActivity, profile
    kv = PagedKVManager(**WALK_SHAPE, device=DEV)
    ops = {}

    def call(kind, fn):
        if kind in ops:
            fn()
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops[kind] = {e.key[:80]: e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith(tracing.PREFIX)}

    walk_wave(kv, list(range(16)), False, call)
    return ops


def coherence_role_inputs():
    """The coherence buffers of the serving path (Qwen3-14B at batch 16,
    prompt 1 024, 4 pods and 4 KV pools, numaPTE: 64 tables of 512 entries,
    d = 3): a wave's 1 024 allocations with the scheduler pod's misses on
    the rows of pods 1-3; then a wave switch (frees and the next wave's
    allocations over the same slots).  Returns [(replicas [4, 64, 512] as
    they stand before the step, (sharers, owner, mutations..., miss))]."""
    kv = PagedKVManager(**WALK_SHAPE, n_pools=4, replicas=True, device=DEV)
    pods = LoopPods(4, DEV)
    cases = []
    for wave in range(2):
        ids = list(range(16 * wave, 16 * wave + 16))
        for i in ids:
            kv.start_sequence(i, 1024, pod=i % 16 // 4)
        kv.physical_tables(ids)
        inputs = kv.coherence_inputs()
        cases.append((kv.replicas.clone(), inputs))
        specs._coherence_prologue("numapte", pods, kv.replicas, *inputs)
        for i in ids:
            kv.maybe_extend(i, 1024 + 64)
            kv.finish_sequence(i)
        kv.sync_device_table()
    return cases


def coherence_roles() -> dict:
    """Each role through K3 on the card against the plain coherence
    functions on the CPU, same inputs, bit-exact, with its K3 launches."""
    degree = specs.PREFETCH_DEGREE          # the manager's default d
    roles = {
        "eager_sync": (lambda e, s, o, t, i, v, ok, m, pods:
                       (coherence.eager_sync(e, t, i, v, ok, pods), s), 1),
        "numapte_apply_filtered": (lambda e, s, o, t, i, v, ok, m, pods:
                                   (coherence.numapte_apply_filtered(
                                       e, s, t, i, v, ok, pods), s), 1),
        "numapte_miss_fetch": (lambda e, s, o, t, i, v, ok, m, pods:
                               coherence.numapte_miss_fetch(e, s, o, m, degree,
                                                            pods), 2),
        "numapte_prologue": (lambda e, s, o, t, i, v, ok, m, pods:
                             coherence.numapte_prologue(e, s, o, t, i, v, ok, m,
                                                        degree, pods), 2),
    }
    out = {}
    real = coherence.pte_gather
    for name, (fn, launches) in roles.items():
        for replicas, inputs in coherence_role_inputs():
            before = pte_gather.launches
            walks = []

            def recorded(*args):
                # the bound reads each launch's drain list and ids before
                # the launch updates the replicas in place
                walks.append(pte_bound(tuple(args) + (None,) * (4 - len(args)),
                                       {})[0])
                return real(*args)

            coherence.pte_gather = recorded
            try:
                got = fn(replicas.clone(), *inputs, LoopPods(4, DEV))
            finally:
                coherence.pte_gather = real
            torch.cuda.synchronize()
            n = pte_gather.launches - before
            want = fn(replicas.cpu(), *(t.cpu() for t in inputs),
                      LoopPods(4, "cpu"))
            for g, w in zip(got, want):
                check(torch.equal(g.cpu(), w), f"K3 as {name} differs from the "
                      "plain coherence function")
            check(n == launches, f"{name}: {n} K3 launches, not {launches}")
            out[name] = {"k3_launches": n, "bit_exact": True,
                         "mutations": int(inputs[2].numel()),
                         "misses": int((inputs[-1] >= 0).sum()),
                         # device time of the role (queued behind a sleep: no
                         # host gap), at the wave switch's inputs
                         "ms": time_ms(lambda: fn(replicas.clone(), *inputs,
                                                  LoopPods(4, DEV))),
                         # its K3 launches' bytes (pte_bound: each drain list
                         # read once, each slot an applied mutation names and
                         # each walked id's frame, flag and window in and out
                         # once), over HBM_BW; the replicas' clone (2 x 512
                         # KB) that the timed call makes is beside it
                         "bound_ms": 1e3 * sum(walks), "bound_by": "bytes",
                         "clone_bound_ms": 1e3 * 2 * replicas.numel() * 4
                         / HBM_BW}
    return out


def walk_one_launch() -> dict:
    """``walk_device_ops``, each kind of walk held to one K3 launch and one
    host-to-device copy."""
    walk_ops = walk_device_ops()
    for kind, names in walk_ops.items():
        check(sum(names.values()) == 2
              and sum(n for k, n in names.items() if "pte_gather" in k) == 1
              and sum(n for k, n in names.items() if "Memcpy HtoD" in k) == 1,
              f"a {kind} walk made {names}, not one kernel and one copy")
    return walk_ops
