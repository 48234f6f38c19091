"""AdamW with decoupled weight decay + cosine schedule, the reference's
arithmetic (``src/repro/optim/adamw.py``) on the port's parameter trees.

Moments are float32; new parameters are cast back to each parameter's
dtype.  ``adamw_update`` writes parameters and moments IN PLACE (a
full-width model's parameters, gradients and moments are 16 bytes a
parameter, so a second copy of either does not fit) and returns them with
the new step.

Weight decay follows the reference's rank rule, ``p.ndim >= 2``, taken on
the reference's tree: there every layer group stacks its layers' leaves on
a leading ``[L, ...]`` axis, so a per-layer vector (a norm scale, a bias,
``q_norm``, the SSD's ``a_log``/``d_skip``/``dt_bias``, the RG-LRU's
vectors) is 2-D and decayed, while the top-level ``final_norm`` (1-D) is
not.  The port keeps each layer apart (``params["groups"][g][layer]``), so
a leaf under ``groups`` is decayed when its own rank is at least 1 and a
top-level leaf when it is at least 2.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_leaves_with_path, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 scalar on the parameters' device
    mu: PyTree
    nu: PyTree


def adamw_init(params: PyTree, dtype=torch.float32) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                                        device=p.device), params),
                      nu=tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                                        device=p.device), params))


def cosine_lr(step: torch.Tensor, *, peak: float = 3e-4, warmup: int = 100,
              total: int = 10_000, floor: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def decays(path, p: torch.Tensor) -> bool:
    """The reference's ``p.ndim >= 2`` on its stacked tree (module doc)."""
    stacked = len(path) > 1 and path[0] == "groups"
    return p.ndim + int(stacked) >= 2


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: AdamWState, *,
                 lr: Optional[torch.Tensor] = None, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0
                 ) -> Tuple[PyTree, AdamWState, torch.Tensor]:
    """One step: global-norm clipping, bias-corrected moments, decoupled
    decay.  ``grads`` holds the gradients of ``params``' leaves in their
    order (the same tree, or a flat list).  ``params`` and the moments of
    ``state`` are updated in place; returns (params, the new state, the
    global gradient norm before clipping)."""
    step = state.step + 1
    if lr is None:
        lr = cosine_lr(step)
    flat_g = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in flat_g))
    scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    if grad_clip is not None:
        scale = torch.minimum(scale, grad_clip / torch.clamp_min(gnorm, 1e-12))

    b1t = 1 - b1 ** step.to(torch.float32)
    b2t = 1 - b2 ** step.to(torch.float32)
    flat_p = list(tree_leaves_with_path(params))
    flat_m, flat_v = tree_leaves(state.mu), tree_leaves(state.nu)
    for (path, p), g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        upd = (m / b1t) / (torch.sqrt(v / b2t) + eps)
        p32 = p.to(torch.float32)
        if decays(path, p):
            upd = upd + weight_decay * p32
        p.copy_(p32 - lr * upd)
    return params, AdamWState(step, state.mu, state.nu), gnorm
