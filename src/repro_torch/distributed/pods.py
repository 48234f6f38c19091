"""The pod axis: the counterpart of the reference's ``shard_map`` over its
``pod`` mesh axis and of the ``lax`` collectives its bodies call.

Every pod-axis function of the port takes the tensors that are sharded over
the axis with a leading *local-pod* dimension ``[p, ...]`` (the pods this
process holds) and replicated tensors as they are.  The axis object supplies
what a ``shard_map`` body gets from ``lax``:

    index()        -> [p] int64, the global index of each local pod
                      (``lax.axis_index``)
    all_gather(x)  x [p, ...]    -> [p, n, ...]   (``lax.all_gather``)
    all_to_all(x)  x [p, n, ...] -> [p, n, ...]   out[i, j] = pod j's x[i]
                                                  (``lax.all_to_all``, untiled)
    psum(x), pmax(x)  x [p, ...] -> [p, ...]      (``lax.psum`` / ``lax.pmax``)

Two backends serve one body:

  * ``LoopPods(n)`` holds all n pods in one process (p = n): an all-gather
    is a broadcast of the stack, an all-to-all a transpose of its first two
    dimensions, a reduction one over dimension 0.  The outputs of
    ``all_gather``, ``psum`` and ``pmax`` are broadcast views (every pod
    holds the same values): read them, never write into them.  This is the
    backend that runs on one GPU.
  * ``DistPods(group)`` holds one pod a rank (p = 1) over
    ``torch.distributed``: ``all_gather_into_tensor``, ``all_to_all_single``,
    ``all_reduce``.  gloo on the CPU; NCCL where each rank has a card (NCCL
    refuses two ranks on one GPU, so on one card only ``LoopPods`` runs).

Both count ``wire_bytes``: for each collective, the bytes that cross between
pods, summed over the n pods.  Every collective is counted as an all-gather
moves it: each pod receives the n - 1 slices of the others (an all-to-all:
the n - 1 chunks addressed to it; psum and pmax: the n - 1 operands it
reduces).  ``calls`` counts collectives by kind.

The same interface serves the in-pod ``data`` and ``model`` axes of the grid
(``launch/mesh.py``): each is a ``Pods`` object of its own, with counters of
its own, carried by the pod axis as ``.data`` and ``.model`` (an axis of
size 1 when the grid has none).  Training through the ``model`` axis needs
collectives that differentiate, Megatron's conjugate pair: ``copy_in`` at a
column-parallel input (identity forward, a sum of the gradients over the
axis backward) and ``psum`` at a row-parallel output (sum forward, identity
backward).  An ``all_gather`` whose every shard reads the whole (the MoE
router's logits, the SSD's B and C, the RG-LRU's gate input) differentiates
to this shard's slice of the sum of the shards' gradients.  ``LoopPods``'
views differentiate as they are (``copy_in`` and ``all_gather`` are
expands, whose backward sums the shards' gradients in shard order, each
shard's own first, as separate ranks would); ``DistPods`` runs them as
``torch.autograd.Function``s.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .._device import DeviceLike, resolve_device


class Pods:
    """The pod axis: ``n`` pods, ``local`` of them in this process."""

    n: int
    local: int
    device: torch.device

    def __init__(self) -> None:
        self.reset_counters()
        self._axes: Dict[str, "Pods"] = {}

    # the grid: the pod axis carries the in-pod axes
    @property
    def pod(self) -> "Pods":
        return self

    @property
    def data(self) -> "Pods":
        return self._axis("data")

    @property
    def model(self) -> "Pods":
        return self._axis("model")

    def _axis(self, name: str) -> "Pods":
        if name not in self._axes:          # a grid without the axis: size 1
            self._axes[name] = LoopPods(1, self.device)
        return self._axes[name]

    def with_axes(self, *, data: Optional["Pods"] = None,
                  model: Optional["Pods"] = None) -> "Pods":
        """This pod axis, carrying ``data`` and ``model`` as its in-pod
        axes (the grid of ``launch/mesh.py``)."""
        for name, axis in (("data", data), ("model", model)):
            if axis is not None:
                self._axes[name] = axis
        return self

    def reset_counters(self) -> None:
        self.wire_bytes = 0
        self.calls: Dict[str, int] = {}

    def _count(self, kind: str, chunk_bytes: int) -> None:
        self.wire_bytes += self.n * (self.n - 1) * chunk_bytes
        self.calls[kind] = self.calls.get(kind, 0) + 1

    def _check(self, x: torch.Tensor, *, routed: bool = False) -> None:
        if x.dim() < 1 or x.shape[0] != self.local or (
                routed and (x.dim() < 2 or x.shape[1] != self.n)):
            want = f"[{self.local}, {self.n}, ...]" if routed else f"[{self.local}, ...]"
            raise ValueError(f"pod axis: expected {want}, got {tuple(x.shape)}")

    @staticmethod
    def _slice_bytes(x: torch.Tensor, lead: int) -> int:
        return (x.numel() // max(1, lead)) * x.element_size()

    def index(self) -> torch.Tensor:
        raise NotImplementedError

    def local_indices(self) -> list:
        """The global index of each local pod, as Python ints (``index()``
        without reading the device)."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering per-shard work (a column-parallel
        input) -> [p, ...], one copy a local shard (views): the identity
        forward, and backward the sum over the axis of the shards'
        gradients (each shard's own summed first, as on separate ranks)."""
        raise NotImplementedError


class LoopPods(Pods):
    """All ``n`` pods in this process, stacked on dimension 0 of every
    sharded tensor."""

    def __init__(self, n: int, device: DeviceLike = None):
        if n < 1:
            raise ValueError(f"LoopPods: {n} pods")
        self.n = self.local = n
        self.device = resolve_device(device)
        super().__init__()

    def index(self) -> torch.Tensor:
        return torch.arange(self.n, device=self.device)

    def local_indices(self) -> list:
        return list(range(self.n))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        self._count("all_gather", self._slice_bytes(x, self.n))
        return x.unsqueeze(0).expand(self.n, *x.shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, routed=True)
        self._count("all_to_all", self._slice_bytes(x, self.n * self.n))
        return x.transpose(0, 1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        self._count("psum", self._slice_bytes(x, self.n))
        return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        self._count("pmax", self._slice_bytes(x, self.n))
        return x.amax(0, keepdim=True).expand_as(x)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        # a broadcast view: the expand's backward sums the shards' gradients
        # over dimension 0; what the sum would move between shards is counted
        if self.n > 1 and x.requires_grad and torch.is_grad_enabled():
            x = _CountGrad.apply(x, self)
        return x.unsqueeze(0).expand(self.n, *x.shape)


class DistPods(Pods):
    """One pod a rank of ``group`` (default: the initialised world), over
    ``torch.distributed``.  ``device`` is the rank's GPU unless it is
    ``"cpu"``, and the constructor raises when there is no GPU.  Tensors must
    lie where the backend works on them (the CPU for gloo, the rank's card
    for NCCL)."""

    def __init__(self, group=None, device: DeviceLike = None):
        import torch.distributed as dist
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("DistPods: call torch.distributed."
                               "init_process_group first")
        self._dist = dist
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local = 1
        super().__init__()

    def index(self) -> torch.Tensor:
        return torch.full((1,), self.rank, dtype=torch.int64, device=self.device)

    def local_indices(self) -> list:
        return [self.rank]

    @staticmethod
    def _wire(x: torch.Tensor) -> torch.Tensor:
        # bool travels as uint8 (not every backend reduces or gathers bool)
        return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _AllGather.apply(x, self)
        return self._gather(x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        self._count("all_gather", self._slice_bytes(x, 1))
        src = self._wire(x[0])
        out = torch.empty((self.n * src.numel(),), dtype=src.dtype,
                          device=src.device)
        gather = getattr(self._dist, "all_gather_single", None) or \
            self._dist.all_gather_into_tensor
        gather(out, src.reshape(-1), group=self.group)
        return out.view((self.n,) + tuple(src.shape)).to(x.dtype)[None]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, routed=True)
        self._count("all_to_all", self._slice_bytes(x, self.n))
        src = self._wire(x[0])
        out = torch.empty_like(src)
        self._dist.all_to_all_single(out, src, group=self.group)
        return out.to(x.dtype)[None]

    def _reduce(self, x: torch.Tensor, kind: str, op) -> torch.Tensor:
        self._check(x)
        self._count(kind, self._slice_bytes(x, 1))
        out = self._wire(x).clone()
        self._dist.all_reduce(out, op=op, group=self.group)
        return out.to(x.dtype)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _PsumIdentityGrad.apply(x, self)
        return self._reduce(x, "psum", self._dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x.detach(), "pmax", self._dist.ReduceOp.MAX)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            x = _CopyIn.apply(x, self)
        return x[None]


class _PsumIdentityGrad(torch.autograd.Function):
    """Megatron's g: the sum over the axis forward (a row-parallel output),
    the identity backward (every shard holds the replicated output's whole
    gradient)."""

    @staticmethod
    def forward(ctx, x, pods):
        return pods._reduce(x, "psum", pods._dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyIn(torch.autograd.Function):
    """Megatron's f: the identity forward (a column-parallel input), the
    sum over the axis backward (each shard holds only its own part of the
    replicated input's gradient)."""

    @staticmethod
    def forward(ctx, x, pods):
        ctx.pods = pods
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        pods = ctx.pods
        return pods._reduce(grad[None], "psum", pods._dist.ReduceOp.SUM)[0], None


class _AllGather(torch.autograd.Function):
    """The all-gather forward; backward, this shard's slice of the sum over
    the axis of the gathered tensor's gradients (each shard's work read
    every slice, so each holds a part of every slice's gradient), as
    ``LoopPods``' broadcast view sums its shards' gradients."""

    @staticmethod
    def forward(ctx, x, pods):
        ctx.pods = pods
        return pods._gather(x)

    @staticmethod
    def backward(ctx, grad):
        pods = ctx.pods
        whole = pods._reduce(grad, "psum", pods._dist.ReduceOp.SUM)
        return whole[:, pods.rank], None


class _CountGrad(torch.autograd.Function):
    """The identity both ways; backward counts the bytes that the sum of
    the shards' gradients would move between them."""

    @staticmethod
    def forward(ctx, x, pods):
        ctx.pods = pods
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.pods._count("psum", grad.numel() * grad.element_size())
        return grad, None
