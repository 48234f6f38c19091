"""Step builders for the pod axis: train and serve steps, with the numaPTE
block-table coherence prologue and the int8 pod gradient leg.

The reference also builds ShapeDtypeStruct cells for an XLA dry run on a
512-device mesh (``build_cell``, ``_state_shardings``, ``PerfOptions``, the
prefill step and the decode geometry that feed them); those wait for ROADMAP
queue 1 item 16 with the ``model`` axis.  Here a step runs its pod-axis work
on a ``repro_torch.distributed.Pods`` axis: ``LoopPods`` on one device,
``DistPods`` over ``torch.distributed``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_map
from ..distributed.compression import compress_allreduce_pods
from ..distributed.pods import Pods
from ..models import greedy_sample, lm_loss
from ..models.common import ModelConfig
from ..models.transformer import decode_step
from ..optim import adamw_update
from ..pagedpt.coherence import eager_sync, numapte_prologue

PyTree = Any

#: the prefetch degree of the reference's cells (their per-step budgets,
#: 1 024 mutations and 256 misses a pod, are ``BlockTableSpec``'s defaults)
PREFETCH_DEGREE = 3


# --------------------------------------------------------------------------- steps
def _grads(cfg: ModelConfig, params: PyTree, batch: Dict[str, torch.Tensor]):
    """(total, metrics, gradients of params' leaves)."""
    cparams = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = lm_loss(cfg, cparams, batch)
    grads = torch.autograd.grad(total, tree_leaves(cparams))
    return total.detach(), metrics, list(grads)


def pod_gradients(cfg: ModelConfig, params: PyTree,
                  batch: Dict[str, torch.Tensor], pods: Pods,
                  compress_pod_grads: bool = False, ef: Optional[List] = None):
    """The pod axis's half of a train step: each local pod differentiates
    its share of the batch (the rows split evenly over the local pods), and
    the pod leg averages the gradients over the axis — in float32, or with
    ``compress_pod_grads`` in int8 with error feedback (``ef``: the per-pod
    residuals [p, ...] of the previous step, None at the first).  Returns
    (the averaged gradient of each leaf, as the step hands it to AdamW;
    metrics: ``loss`` and ``aux`` the pods' mean, ``tokens`` their sum; the
    new error buffers, ``ef`` itself for the float32 leg)."""
    p, n = pods.local, pods.n
    stacked, pod_metrics = None, []
    for i in range(p):
        share = {k: v.view(p, v.shape[0] // p, *v.shape[1:])[i]
                 for k, v in batch.items()}
        _, m, g = _grads(cfg, params, share)
        if stacked is None:      # [p, ...] a leaf, filled pod by pod
            stacked = [torch.empty((p,) + t.shape, dtype=t.dtype,
                                   device=t.device) for t in g]
        for buf, t in zip(stacked, g):
            buf[i].copy_(t)
        del g
        pod_metrics.append({k: v.detach() for k, v in m.items()})
    new_ef = ef
    if compress_pod_grads:
        avg, new_ef = compress_allreduce_pods(stacked, ef, pods)
        grads = [a[0] for a in avg]
    else:
        grads = [pods.psum(g)[0] / n for g in stacked]
    del stacked
    metrics = {k: pods.psum(torch.stack([m[k] for m in pod_metrics]))[0]
               for k in pod_metrics[0]}
    metrics["loss"] = metrics["loss"] / n
    metrics["aux"] = metrics["aux"] / n
    return grads, metrics, new_ef


def build_train_step(cfg: ModelConfig, compress_pod_grads: bool = False,
                     pods: Optional[Pods] = None) -> Callable:
    """``step(params, opt_state, batch, ef=None)``: gradients, then one
    ``adamw_update`` (in place).  Without ``pods`` the gradients are
    ``lm_loss``'s; with ``pods`` they are ``pod_gradients``' average.
    Returns (params, opt_state, metrics), and the new error buffers as a
    fourth item when the leg is compressed or ``ef`` is given."""
    def train_step(params, opt_state, batch, ef=None):
        if pods is None:
            _, metrics, grads = _grads(cfg, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
            new_ef = ef
        else:
            grads, metrics, new_ef = pod_gradients(
                cfg, params, batch, pods, compress_pod_grads, ef)
        params, new_opt, gnorm = adamw_update(params, grads, opt_state)
        metrics = dict(metrics, grad_norm=gnorm)
        if compress_pod_grads or ef is not None:
            return params, new_opt, metrics, new_ef
        return params, new_opt, metrics
    return train_step


@contextlib.contextmanager
def timed(into: List, device: torch.device):
    """Append a (start, end) pair around the block: CUDA events on the
    card (read them with ``elapsed_ms`` once the device is synchronised),
    host clock readings on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        yield
        end.record()
    else:
        start = time.perf_counter()
        yield
        end = time.perf_counter()
    into.append((start, end))


def elapsed_ms(pair) -> float:
    start, end = pair
    if isinstance(start, float):
        return 1e3 * (end - start)
    return start.elapsed_time(end)


def build_serve_step(cfg: ModelConfig, sp: bool = False,
                     coherence: str = "none", pods: Optional[Pods] = None,
                     sample: Callable = greedy_sample,
                     prologue_timer: Optional[List] = None) -> Callable:
    """``step(params, state, tokens, phys_blocks, *coh_args)``: the
    block-table coherence prologue over ``pods`` (when ``coherence`` is
    ``eager`` or ``numapte`` and ``coh_args`` are given: the replicas [p, T,
    epb] and the buffers of ``_coherence_prologue``), then one decode step
    (sequence-parallel over ``pods`` with ``sp``), then ``sample`` of its
    logits (greedy).  Returns (sampled tokens, state) and, after a prologue,
    its (replicas, sharers) as a third item.  ``prologue_timer``: a list
    that gets a ``timed`` pair around each prologue."""
    if coherence not in ("none", "eager", "numapte"):
        raise ValueError(f"coherence {coherence!r}")

    def step(params, state, tokens, phys_blocks, *coh_args):
        coh_out = None
        if coherence != "none" and coh_args:
            timer = (contextlib.nullcontext() if prologue_timer is None
                     else timed(prologue_timer, coh_args[0].device))
            with timer:
                coh_out = _coherence_prologue(coherence, pods, *coh_args)
        logits, state = decode_step(cfg, params, state, tokens, phys_blocks,
                                    sp=sp, pods=pods)
        if coh_out is None:
            return sample(logits), state
        return sample(logits), state, coh_out
    return step


def _coherence_prologue(mode: str, pods: Pods, entries, sharers, owner,
                        mut_t, mut_i, mut_v, mut_ok, miss
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step block-table coherence over the pod axis — the paper's
    mechanism in the step.  EAGER gathers every pod's mutation buffer every
    step and applies all of it (Mitosis: one K3 launch); NUMAPTE applies
    only sharer-filtered updates and fetches misses from owners with
    degree-d prefetch (two K3 launches).  entries [p, T, epb] are updated in
    place; returns (entries, sharers)."""
    if mode == "eager":
        return eager_sync(entries, mut_t, mut_i, mut_v, mut_ok, pods), sharers
    return numapte_prologue(entries, sharers, owner, mut_t, mut_i, mut_v,
                            mut_ok, miss, PREFETCH_DEGREE, pods)
