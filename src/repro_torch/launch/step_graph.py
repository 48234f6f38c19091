"""The served decode step replayed as one CUDA graph.

A decode step at serving widths is some 2 500 small launches, and the host
takes longer to enqueue them than the card takes to run them.  A
``StepGraph`` wraps the step's model call (``decode_on_grid`` and greedy
sampling, ``launch/specs.py:build_serve_step``): the first call with a
given key runs it eagerly, as it always ran, on a capture stream of the
device, and returns that result; it then captures the same call into a
``torch.cuda.CUDAGraph``, which launches nothing.  Every later call with
that key copies its ``tokens``, ``phys_blocks`` and ``state.seq_lens`` into
the graph's static inputs, replays, and returns fresh copies of the sampled
tokens and the new lengths (a caller may keep every step's tokens).  The
caches are written in place, as the eager step writes them.

The key is everything the graph bakes in: the inputs' shapes and dtypes,
and the storage of the parameters' leaves and of the decode state's
caches, which the graph holds alive.  Another state or parameter tree
captures its own graph; at most ``GRAPHS`` are kept, the least recently
used freed first.

What a capture must see:
- K1's and K4's scratch (``kernels/paged_attention/ops.py:_scratch``) is keyed by
  stream; the eager first call makes the capture stream's, and the graph
  holds the tensors it baked in, since a later first call may replace them.
- The wrappers' launch counters count Python calls: a capture's counts are
  taken back, and each replay adds them, so they count launches that ran.
- The port's spans record nothing inside a capture.  A replay is one
  ``decode`` span counting ``graph`` = 1 (``decode_step``'s own span counts
  0); the inner spans (``layer``, ``attn`` ...) exist only on eager steps.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import tracing
from ..distributed.pods import LoopPods, Pods
from ..kernels.fifo_miss.ops import fifo_miss_ids
from ..kernels.flash_attention.ops import flash_attention, flash_attention_bwd
from ..kernels.paged_attention.ops import (mla_decode, paged_attention,
                                          stream_scratch)
from ..kernels.pte_gather.ops import pte_gather

#: graphs kept by one ``StepGraph``
GRAPHS = 4

#: the wrappers' launch counters, (function, attribute)
COUNTERS = ((paged_attention, "launches"),
            (paged_attention, "softcap_launches"),
            (mla_decode, "launches"),
            (flash_attention, "launches"),
            (flash_attention, "softcap_launches"),
            (flash_attention_bwd, "launches"),
            (flash_attention_bwd, "softcap_launches"),
            (pte_gather, "launches"),
            (fifo_miss_ids, "launches"))

# one capture stream a device: every capture's K1 scratch is that stream's
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def graphed(device: torch.device, grid: Optional[Pods], *, sp: bool,
            sample: Optional[Callable]) -> bool:
    """Whether a serve step replays a graph: on a CUDA device, with grad
    disabled, the default sampler, no sequence parallelism, and a grid (if
    any) in this process (``LoopPods`` on every axis) with data and model
    axes of one.  Every other call is eager: the CPU, ``DistPods`` (gloo's
    collectives cannot be captured), a split data or model axis (the
    vocab-split sampler makes a host tensor), SP, and a caller's sampler."""
    if (device.type != "cuda" or torch.is_grad_enabled() or sp
            or sample is not None):
        return False
    if grid is None:
        return True
    axes = (grid, grid.data, grid.model)
    return (all(isinstance(a, LoopPods) for a in axes)
            and grid.data.n == 1 and grid.model.n == 1)


def _tensors(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """``tree``'s tensors, in order (a lean ``tree_leaves``: it runs every
    step)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    return out


def _counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, name) for fn, name in COUNTERS)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    tokens: torch.Tensor          # static inputs
    phys: torch.Tensor
    lens: torch.Tensor
    logits: torch.Tensor          # static outputs
    sampled: torch.Tensor
    new_lens: torch.Tensor
    counts: Tuple[int, ...]       # the launches of one replay, by COUNTERS
    held: Tuple                   # what the graph reads: kept alive


class StepGraph:
    """``run(params, state, tokens, phys_blocks) -> (logits, sampled,
    state)`` replayed as a CUDA graph (module doc)."""

    def __init__(self, run: Callable) -> None:
        self.run = run
        self._graphs: "collections.OrderedDict[Tuple, _Graph]" = \
            collections.OrderedDict()

    def __call__(self, params, state, tokens: torch.Tensor,
                 phys_blocks: torch.Tensor):
        baked = _tensors(state.caches, _tensors(params, []))
        key = (tokens.device, tokens.shape, tokens.dtype, phys_blocks.shape,
               phys_blocks.dtype, state.seq_lens.shape, state.seq_lens.dtype,
               state.layout, tuple(t.data_ptr() for t in baked))
        g = self._graphs.get(key)
        if g is None:
            return self._capture(key, baked, params, state, tokens,
                                 phys_blocks)
        self._graphs.move_to_end(key)
        with tracing.span("decode", graph=1):
            g.tokens.copy_(tokens)
            g.phys.copy_(phys_blocks)
            g.lens.copy_(state.seq_lens)
            g.graph.replay()
            for (fn, name), n in zip(COUNTERS, g.counts):
                setattr(fn, name, getattr(fn, name) + n)
            sampled, lens = g.sampled.clone(), g.new_lens.clone()
        return g.logits, sampled, state._replace(seq_lens=lens)

    def _capture(self, key, baked, params, state, tokens, phys_blocks):
        """The eager call on the capture stream (its result is returned),
        then the capture of the same call on static inputs."""
        device = tokens.device
        stream = _STREAMS.get(device.index)
        if stream is None:
            stream = _STREAMS[device.index] = torch.cuda.Stream(device)
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = self.run(params, state, tokens, phys_blocks)
        caller.wait_stream(stream)
        s_tokens, s_phys, s_lens = (tokens.clone(), phys_blocks.clone(),
                                    state.seq_lens.clone())
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        # no collection inside the capture: freeing a graph there (one held
        # by garbage in a cycle) invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            # the capture synchronises the device first: no replay of a
            # graph freed below is still running
            with tracing.paused(), torch.cuda.graph(graph, stream=stream):
                logits, sampled, st = self.run(params, state._replace(
                    seq_lens=s_lens), s_tokens, s_phys)
            launched = tuple(a - b for a, b in zip(_counts(), before))
        finally:
            if collecting:
                gc.enable()
            for (fn, name), n in zip(COUNTERS, before):
                setattr(fn, name, n)
        held = (baked, stream_scratch(device.index, stream.cuda_stream))
        self._graphs[key] = _Graph(graph, s_tokens, s_phys, s_lens, logits,
                                   sampled, st.seq_lens, launched, held)
        while len(self._graphs) > GRAPHS:
            self._graphs.popitem(last=False)
        return out
