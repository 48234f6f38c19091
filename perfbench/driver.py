"""The request driver: the program's own serving pieces, called in the order
``repro_torch/launch/serve.py:serve()`` calls them, under a schedule of
requests.

``serve()`` itself serves a fixed count of requests and builds a new
manager, state and warm-up on every call, so the driver holds one of each
and forms waves as requests arrive.  For each wave it calls
``PagedKVManager.start_sequence`` for every row (the host protocol, rows
homed by ``kvcache.gather.pool_of_rows``), ``physical_tables`` (the page
walk, K3), ``models.prefill`` (cuBLAS, K2, the scatter into the paged
slabs); then for each token ``maybe_extend``, ``physical_tables(record=t
% 4 == 0)``, the step of ``launch.specs.build_serve_step`` (the coherence
prologue over a ``LoopPods`` grid, ``decode_on_grid``: cuBLAS and K1,
greedy sampling) and the extra prologue rounds while ``coherence_pending``
holds; ``finish_sequence`` for every row at the wave's end, and the
manager's own checks, as ``serve()`` makes them.

Where it departs from ``serve()``: each step's sampled tokens are copied to
the host, and that copy is when they are delivered (and timestamped); a
wave starts when the previous one has ended and a request is waiting, and
takes up to ``batch`` waiting requests in arrival order, the other rows
padded with -1 tables as ``serve()`` pads its last wave; the KV pool holds
what the mix's file says (one full wave at its longest).  Like ``serve()``
the driver discards prefill's logits and feeds token 0 to the first decode
step.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.pte_gather.ops import pte_gather
from repro_torch.kvcache import PagedKVManager
from repro_torch.kvcache.gather import pool_of_rows
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import init_decode_state, prefill
from repro_torch.pagedpt.blocktable import CoherenceMode

from . import check
from .tracing import Profiler, Spans, TraceSlice
from .traffic import Request


@dataclasses.dataclass
class Step:
    t0: float                      # the walk starts
    t1: float                      # the tokens are on the host
    lens: Tuple[int, ...]          # live rows' lengths, the new token included
    timings: Tuple[int, int]       # its prologue pairs in ``Driver.timings``
    prologue_ms: float = 0.0


@dataclasses.dataclass
class Prefill:
    t0: float
    t1: float                      # synchronised
    rows: int                      # batch rows the prefill computes
    live: int                      # of them requests
    prompt_len: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, cfg, params, mix: Dict, deploy: Dict,
                 device: torch.device, spans: Optional[Spans] = None):
        self.cfg, self.params, self.mix = cfg, params, mix
        self.device = device
        self.spans = spans or Spans()
        self.batch, self.S, self.G = (mix["batch"], mix["prompt_len"],
                                      mix["gen_len"])
        bt = cfg.kv_block_tokens
        self.max_blocks = -(-(self.S + self.G) // bt) + 1
        frames = mix["kv_frames"]
        if frames < self.batch * self.max_blocks:
            raise ValueError(f"{frames} KV frames hold less than a wave: "
                             f"{self.batch} x {self.max_blocks}")
        pods, pools, mode = deploy["pods"], deploy["pools"], deploy["mode"]
        self.kv = PagedKVManager(
            n_frames=frames, block_tokens=bt, max_blocks_per_seq=self.max_blocks,
            n_pods=pods, mode=CoherenceMode(mode), n_pools=pools,
            replicas=True, device=device)
        self.grid = make_debug_mesh(pods, device=device)
        self.state = init_decode_state(
            cfg, self.batch, frames, self.max_blocks, n_pools=pools,
            device=device,
            kv_split=specs.kv_split(cfg, self.grid, specs.make_rules(cfg, self.grid)),
            state_split=specs.state_split(params, self.grid))
        self.home = (pool_of_rows(self.batch, pools).tolist() if pools > 1
                     else [i % pods for i in range(self.batch)])
        self.mode = mode
        self.timings: List = []
        self.step_fn = specs.build_serve_step(
            cfg, coherence=mode, pods=self.grid, prologue_timer=self.timings)
        self.steps: List[Step] = []
        self.prefills: List[Prefill] = []
        self.checks: Dict[str, float] = {}
        self.k3_prologue = 0

    # ------------------------------------------------------------ pieces
    def _extra_rounds(self) -> None:
        """Prologue rounds for what one step's budgets left queued."""
        kv = self.kv
        while kv.coherence_pending():
            before = pte_gather.launches
            with specs.timed(self.timings, self.device):
                specs._coherence_prologue(self.mode, self.grid, kv.replicas,
                                          *kv.coherence_inputs())
            self.k3_prologue += pte_gather.launches - before

    def _decode(self, st, tokens, phys):
        before = pte_gather.launches
        tokens, st, _ = self.step_fn(self.params, st, tokens, phys,
                                     self.kv.replicas,
                                     *self.kv.coherence_inputs())
        self.k3_prologue += pte_gather.launches - before
        return tokens, st

    @torch.no_grad()
    def warm_up(self) -> None:
        """One prefill and one decode step at the cell's shapes, all rows
        padding (-1 tables: nothing reaches the slabs), and the walk, so
        that no kernel is built or first launched inside the window."""
        B = self.batch
        phys = self.kv.physical_tables([-1] * B)
        prompts = torch.zeros((B, self.S), dtype=torch.int32, device=self.device)
        _, st = prefill(self.cfg, self.params, prompts, self.state, phys)
        tokens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        tokens, _ = self._decode(st, tokens, phys)
        tokens.cpu()
        _sync(self.device)
        self.timings.clear()
        self.k3_prologue = 0

    # ------------------------------------------------------------ a wave
    @torch.no_grad()
    def run_wave(self, wave: List[Request], *, stop_at: Optional[float] = None,
                 profiler: Optional[Profiler] = None) -> Optional[TraceSlice]:
        """Serve one wave; with ``stop_at`` stop decoding once the host
        clock passes it.  After the wave's last step the replicas and the
        frames its rows read are checked (``check.table_report``), before
        the rows are freed.  A profiler starts before the wave's prefill and
        stops after its ``trace_decode_steps``-th decode step."""
        spans, kv, dev = self.spans, self.kv, self.device
        B, S, G = self.batch, self.S, self.G
        n = len(wave)
        active = [r.rid for r in wave] + [-1] * (B - n)
        trace = None
        if profiler is not None:
            profiler.start()
        with spans("admit"):
            for i, r in enumerate(wave):
                r.row = i
                kv.start_sequence(r.rid, S, pod=self.home[i])
            host = np.zeros((B, S), dtype=np.int32)
            for i, r in enumerate(wave):
                host[i] = r.prompt
            prompts = torch.from_numpy(host).to(dev)
        with spans("prefill"):
            t0 = time.perf_counter()
            phys = kv.physical_tables(active)
            _, st = prefill(self.cfg, self.params, prompts, self.state, phys)
            _sync(dev)
        self.prefills.append(Prefill(t0, time.perf_counter(), B, n, S))
        tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        for t in range(G):
            t_step = time.perf_counter()
            first = len(self.timings)
            with spans("walk"):
                for r in wave:
                    kv.maybe_extend(r.rid, S + t + 1)
                phys = kv.physical_tables(active, record=(t % 4 == 0))
            with spans("step"):
                tokens, st = self._decode(st, tokens, phys)
            with spans("rounds"):
                self._extra_rounds()
            with spans("deliver"):
                out = tokens.cpu().numpy()
            now = time.perf_counter()
            for i, r in enumerate(wave):
                r.token_times.append(now)
                r.tokens.append(int(out[i]))
            self.steps.append(Step(t_step, now, (S + t + 1,) * n,
                                   (first, len(self.timings))))
            if profiler is not None and t + 1 == self.mix["trace_decode_steps"]:
                trace = self._stop_trace(profiler)
                profiler = None
            if stop_at is not None and now >= stop_at:
                break
        if profiler is not None:
            trace = self._stop_trace(profiler)
        with spans("check"):
            check.table_report(kv, phys, active, self.home, into=self.checks)
        with spans("finish"):
            for r in wave:
                kv.finish_sequence(r.rid)
            kv.host.check_invariants()
            kv.check_device_table()
        return trace

    def _stop_trace(self, profiler: Profiler) -> TraceSlice:
        trace = profiler.stop()
        trace.prefill = (self.prefills[-1].rows, self.prefills[-1].prompt_len)
        trace.step_lens = [s.lens for s in self.steps
                           if s.t0 >= self.prefills[-1].t0]
        return trace

    # ------------------------------------------------------------ the run
    def serve(self, source: Iterator[Request], *, lead_in: float,
              seconds: float, backlog: bool, trace: bool = False) -> Dict:
        """Serve ``source`` (requests in due order) from now: the window
        opens ``lead_in`` seconds later and lasts ``seconds``.  A backlog
        stops at the window's close; an open loop sends nothing due after
        it and serves on until every request due inside it has its first
        token.  Returns the schedule's origin, the window, every request
        sent, and the traced slice."""
        B = self.batch
        origin = time.perf_counter()
        w0 = origin + lead_in
        w1 = w0 + seconds
        pending: collections.deque = collections.deque()
        sent: List[Request] = []
        nxt = next(source, None)
        slice_: Optional[TraceSlice] = None
        want_trace = trace

        def arrive() -> None:
            nonlocal nxt
            now = time.perf_counter()
            while nxt is not None and (
                    origin + nxt.due <= now and origin + nxt.due < w1
                    and not (backlog and len(pending) >= B)):
                pending.append(nxt)
                sent.append(nxt)
                nxt = next(source, None)
            if nxt is not None and origin + nxt.due >= w1:
                nxt = None

        while True:
            arrive()
            now = time.perf_counter()
            if backlog and now >= w1:
                break
            if not pending:
                if nxt is None:
                    if now >= w1:
                        break
                    time.sleep(w1 - now)
                    continue
                time.sleep(max(0.0, origin + nxt.due - now))
                continue
            wave = [pending.popleft() for _ in range(min(B, len(pending)))]
            for r in wave:
                r.admitted = now
            prof = None
            if want_trace and now >= w0:
                prof, want_trace = Profiler(self.spans), False
            got = self.run_wave(wave, stop_at=w1 if backlog else None,
                                profiler=prof)
            slice_ = slice_ or got
        self._extra_rounds()         # deliver the last frees
        _sync(self.device)
        for s in self.steps:
            s.prologue_ms = sum(specs.elapsed_ms(p)
                                for p in self.timings[s.timings[0]:s.timings[1]])
        return {"origin": origin, "w0": w0, "w1": w1, "requests": sent,
                "trace": slice_}
