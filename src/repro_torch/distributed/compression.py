"""Int8 error-feedback gradient compression for the pod axis.

Cross-pod links are the scarce bandwidth at scale, so the pod-axis gradient
all-reduce runs on int8-quantized tensors with per-tensor scales and an
error-feedback buffer (the quantization residual is carried into the next
step, so compression error does not bias the gradient: Karimireddy et
al.-style EF).  In-pod reduction stays full precision.  Plain PyTorch on
every device, as the reference's is plain jnp.

Usage inside a step (gradient leaves sharded over the pod axis, [p, ...]):
    grads, ef = compress_allreduce_pods(grads, ef, pods)

A leaf split over the grid's model axis (``model``, ``split``) takes the
reference's scale, the whole leaf's: the ``pmax`` over the model axis of
its shards' maxima, whether the shards are this process's (``LoopPods``)
or one a process (``DistPods``).  The pmax is counted in the model axis's
``wire_bytes``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from .pods import Pods

PyTree = Any


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 scalar) of one tensor: scale = max|x| / 127 (at
    least 1e-12 / 127), q = round-half-even(x / scale) clipped to +-127.
    ``amax``: max|x| of the whole tensor when x is a part of it."""
    amax = x.abs().amax() if amax is None else amax
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(grads: PyTree) -> PyTree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _one(g: torch.Tensor, e: Optional[torch.Tensor], pods: Pods,
         model: Optional[Pods] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf g [p, ...] and its error buffer e [p, ...] (None: zeros) ->
    (the pod average [p, ...] in g's dtype, the new error buffer [p, ...]).
    Each pod's tensor is quantized on its own scale, one pod at a time, so
    the temporaries are one pod's leaf.  ``model``: the model axis that
    splits this leaf, each pod's tensor [local shards, ...]; its scale is
    then the whole leaf's (one ``pmax`` of the shards' maxima a pod)."""
    p = g.shape[0]
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    scale = torch.empty((p,), dtype=torch.float32, device=g.device)
    new_e = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    for i in range(p):
        g32 = g[i].to(torch.float32) if e is None else g[i].to(torch.float32) + e[i]
        amax = (None if model is None
                else model.pmax(g32.abs().flatten(1).amax(1))[0])
        q_i, s_i = quantize_int8(g32, amax)
        q[i].copy_(q_i)
        scale[i] = s_i
        torch.sub(g32, dequantize_int8(q_i, s_i), out=new_e[i])
    # the wire carries the int8 payloads and one float32 scale a pod: gather
    # them and reduce locally (an int8 sum would overflow).  Every local pod
    # gathers the same slices, so the first one's reduction is every pod's.
    # The sum runs over the pods in order, each term fused into the running
    # sum (one rounding a term), as the reference's dot computes it.
    q_all = pods.all_gather(q)[0]                                 # [n, ...]
    s_all = pods.all_gather(scale)[0]                             # [n]
    summed = s_all[0] * q_all[0].to(torch.float32)
    for j in range(1, pods.n):
        summed = torch.addcmul(summed, s_all[j].expand_as(summed),
                               q_all[j].to(torch.float32))
    avg = (summed / pods.n).to(g.dtype)
    return avg.unsqueeze(0).expand(g.shape), new_e


def compress_allreduce_pods(grads: PyTree, ef: Optional[PyTree], pods: Pods,
                            *, model: Optional[Pods] = None,
                            split: Optional[List[bool]] = None
                            ) -> Tuple[PyTree, PyTree]:
    """All-reduce each gradient leaf [p, ...] over the pod axis in int8 with
    error feedback.  ``ef`` None is the first step's zeros (none are
    allocated).  ``model`` / ``split``: the grid's model axis and, for each
    leaf, whether it is split over it (its pod slices [local shards, ...]):
    a split leaf's scale is the whole leaf's (module doc).  Returns (the
    averaged gradients, in each leaf's dtype, [p, ...] as broadcast views:
    every pod holds the same average; the new error buffers, float32
    [p, ...])."""
    leaves = tree_leaves(grads)
    errs = [None] * len(leaves) if ef is None else tree_leaves(ef)
    split = split or [False] * len(leaves)
    axis = model if model is not None and model.n > 1 else None
    out = [_one(g, e, pods, axis if s else None)
           for g, e, s in zip(leaves, errs, split)]
    it_g, it_e = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), grads))


def compression_wire_bytes(grads: PyTree) -> Tuple[int, int]:
    """(bytes_fp32, bytes_int8) that one pod-axis all-reduce of ``grads``
    (one pod's leaves) would move."""
    leaves = tree_leaves(grads)
    total = sum(g.numel() for g in leaves)
    return total * 4, total * 1 + len(leaves) * 4
