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
    reduce_scatter(x, dim)  x [p, ...] -> [p, ..., S/n, ...]  the sum over
                      the axis, shard i keeping chunk i of ``dim``
                      (``lax.psum_scatter``, tiled); ``dim`` counts in a
                      shard's tensor x[i]
    all_gather_dim(x, dim)  x [p, ..., S/n, ...] -> [..., S, ...]  the
                      shards' chunks joined along ``dim`` (``lax.all_gather``,
                      tiled), as one replicated tensor
    scatter_dim(x, dim)  a replicated x [..., S, ...] -> [p, ..., S/n, ...]
                      each shard's chunk (no traffic forward)

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
reduces; a reduce-scatter: the n - 1 slices of size 1/n of the others'
operands that it sums into its chunk).  ``calls`` counts collectives by
kind.

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

Megatron sequence parallelism adds the second conjugate pair: a block's
row-parallel output is a ``reduce_scatter`` along the sequence (backward:
an all-gather of each shard's gradient chunk), and its input an
``all_gather_dim`` along the sequence (backward: a reduce-scatter of the
shards' partial gradients of the whole, or with ``partial=False``, where
every shard's gradient of the whole is complete already, its own chunk of
it).  ``scatter_dim`` enters the split from a replicated tensor (backward:
an all-gather), and ``sum_grads`` marks a replicated parameter that each
shard reads with its own rows only (a norm's scale between blocks):
identity forward, the sum of the shards' gradients backward.
``models.transformer.SeqParallel`` is the model axis as a block sees it
under sequence parallelism (its input already gathered, its output
reduce-scattered).
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

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def all_gather_dim(self, x: torch.Tensor, dim: int, *,
                       partial: bool = True) -> torch.Tensor:
        raise NotImplementedError

    def scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        raise NotImplementedError

    def sum_grads(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # a tensor-parallel block's boundary (``models.transformer.SeqParallel``
    # overrides these)
    def block_in(self, x: torch.Tensor) -> torch.Tensor:
        """A block's replicated input x -> each local shard's copy
        ``[p, ...]`` (``copy_in``)."""
        return self.copy_in(x)

    def block_out(self, parts: torch.Tensor) -> torch.Tensor:
        """The local shards' partial outputs ``[p, ...]`` -> the block's
        output, their sum over the axis (``psum``), replicated."""
        return self.psum(parts)[0]

    def block_extra(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated term added to a block's output, in the output's
        layout (replicated: as it is)."""
        return x

    @staticmethod
    def _chunks(whole: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        """[..., S, ...] -> [n, ..., S/n, ...]: chunk i of ``dim`` (views)."""
        if whole.shape[dim] % n:
            raise ValueError(f"{whole.shape[dim]} rows do not split over {n} "
                             "shards")
        return whole.unflatten(dim, (n, -1)).movedim(dim, 0)

    @staticmethod
    def _joined(x: torch.Tensor, dim: int) -> torch.Tensor:
        """[p, ..., S/n, ...] -> [..., p S/n, ...]: the chunks in shard
        order along ``dim`` (a view when they are one buffer's chunks)."""
        return x.movedim(0, dim).flatten(dim, dim + 1)

    def _grad_counted(self, x: torch.Tensor, kind: str,
                      chunk_bytes: int) -> torch.Tensor:
        """``x``, whose backward counts one collective of ``kind`` moving
        ``chunk_bytes`` a shard pair (LoopPods' autograd moves nothing)."""
        if self.n > 1 and x.requires_grad and torch.is_grad_enabled():
            return _CountBackward.apply(x, self, kind, chunk_bytes)
        return x


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
        x = self._grad_counted(x, "psum", x.numel() * x.element_size())
        return x.unsqueeze(0).expand(self.n, *x.shape)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        # psum's sum, then chunk i of ``dim`` for shard i (views of the
        # sum): bit for bit a psum followed by a slice; backward, autograd
        # joins the shards' gradient chunks (an all-gather, counted)
        self._check(x)
        chunk = self._slice_bytes(x, self.n * self.n)
        self._count("reduce_scatter", chunk)
        whole = x.sum(0, keepdim=True, dtype=x.dtype)[0]
        return self._chunks(self._grad_counted(whole, "all_gather", chunk),
                            self.n, dim)

    def all_gather_dim(self, x: torch.Tensor, dim: int, *,
                       partial: bool = True) -> torch.Tensor:
        # the chunks joined (a view when they are one buffer's); backward,
        # the expand of each consumer sums the shards' gradients and the
        # join splits them into chunks again (a reduce-scatter, counted
        # when the shards' gradients are partial)
        self._check(x)
        chunk = self._slice_bytes(x, self.n)
        self._count("all_gather", chunk)
        whole = self._joined(x, dim)
        return (self._grad_counted(whole, "reduce_scatter", chunk) if partial
                else whole)

    def scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        chunk = (x.numel() // self.n) * x.element_size()
        return self._chunks(self._grad_counted(x, "all_gather", chunk),
                            self.n, dim)

    def sum_grads(self, x: torch.Tensor) -> torch.Tensor:
        # one tensor read by every shard's rows: autograd sums its gradient
        # over them already; what the sum would move is counted
        return self._grad_counted(x, "psum", x.numel() * x.element_size())


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

    def _reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """x [1, ...] -> [1, ..., S/n, ...], counted."""
        self._check(x)
        self._count("reduce_scatter", self._slice_bytes(x, self.n))
        src = self._wire(x[0].movedim(dim, 0))
        if src.shape[0] % self.n:
            raise ValueError(f"{src.shape[0]} rows do not split over "
                             f"{self.n} shards")
        out = torch.empty((src.shape[0] // self.n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        scatter = getattr(self._dist, "reduce_scatter_single", None) or \
            self._dist.reduce_scatter_tensor
        scatter(out, src, group=self.group)
        return out.to(x.dtype).movedim(0, dim)[None]

    def _gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """x [1, ..., S/n, ...] -> [..., S, ...], counted."""
        self._check(x)
        self._count("all_gather", self._slice_bytes(x, 1))
        src = self._wire(x[0].movedim(dim, 0))
        out = torch.empty((self.n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather = getattr(self._dist, "all_gather_single", None) or \
            self._dist.all_gather_into_tensor
        gather(out, src, group=self.group)
        return out.to(x.dtype).movedim(0, dim)

    def _my_chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return x.chunk(self.n, dim)[self.rank][None]

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _ReduceScatter.apply(x, self, dim)
        return self._reduce_scatter(x, dim)

    def all_gather_dim(self, x: torch.Tensor, dim: int, *,
                       partial: bool = True) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _GatherDim.apply(x, self, dim, partial)
        return self._gather_dim(x, dim)

    def scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _ScatterDim.apply(x, self, dim)
        return self._my_chunk(x, dim)

    def sum_grads(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _CopyIn.apply(x, self)
        return x


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


class _ReduceScatter(torch.autograd.Function):
    """The reduce-scatter along ``dim`` forward; backward, the all-gather of
    the shards' gradient chunks (each shard's share of the sum was read by
    its own rows only)."""

    @staticmethod
    def forward(ctx, x, pods, dim):
        ctx.pods, ctx.dim = pods, dim
        return pods._reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.pods._gather_dim(grad, ctx.dim)[None], None, None


class _GatherDim(torch.autograd.Function):
    """The all-gather along ``dim`` forward; backward, the reduce-scatter of
    the shards' gradients of the whole (``partial``: each shard's work read
    the whole and holds a part of its gradient), or this shard's chunk of
    a gradient every shard holds whole."""

    @staticmethod
    def forward(ctx, x, pods, dim, partial):
        ctx.pods, ctx.dim, ctx.partial = pods, dim, partial
        return pods._gather_dim(x, dim)

    @staticmethod
    def backward(ctx, grad):
        pods, dim = ctx.pods, ctx.dim
        if ctx.partial:
            return pods._reduce_scatter(grad[None], dim), None, None, None
        return pods._my_chunk(grad, dim), None, None, None


class _ScatterDim(torch.autograd.Function):
    """This shard's chunk of a replicated tensor forward; backward, the
    all-gather of the shards' chunks of the gradient (the replicated
    tensor's whole gradient on every shard)."""

    @staticmethod
    def forward(ctx, x, pods, dim):
        ctx.pods, ctx.dim = pods, dim
        return pods._my_chunk(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.pods._gather_dim(grad, ctx.dim), None, None


class _CountBackward(torch.autograd.Function):
    """The identity both ways; backward counts one collective of ``kind``
    that moves ``chunk_bytes`` a pair of shards."""

    @staticmethod
    def forward(ctx, x, pods, kind, chunk_bytes):
        ctx.pods, ctx.kind, ctx.chunk = pods, kind, chunk_bytes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.pods._count(ctx.kind, ctx.chunk)
        return grad, None, None, None
