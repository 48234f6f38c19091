"""The grid a run builds, in place of the reference's device meshes.

The reference's ``make_production_mesh`` / ``make_debug_mesh`` build
``jax.make_mesh`` meshes: ``(data=16, model=16)`` in a pod, and ``(pod=2,
data=16, model=16)`` across pods, whose ``pod`` axis carries pure data
parallelism plus the numaPTE block-table coherence domain.  The port's grid
is its pod axis (``repro_torch.distributed.pods``), which carries the
in-pod axes as ``.data`` (the batch split, gradients averaged) and
``.model`` (tensor parallelism), each a ``Pods`` of its own.  Both are
functions, so importing this module touches no device or process group.
"""
from __future__ import annotations

from .._device import DeviceLike, resolve_device
from ..distributed.pods import DistPods, LoopPods, Pods


def make_debug_mesh(n_pods: int = 4, *, data: int = 1, model: int = 1,
                    device: DeviceLike = None) -> Pods:
    """``n_pods`` pods x ``data`` x ``model`` in this process (``LoopPods``
    on every axis): the grid on one device, the GPU unless
    ``device="cpu"``.  Returns the pod axis, carrying ``.data`` and
    ``.model``."""
    return LoopPods(n_pods, device).with_axes(
        data=LoopPods(data, device), model=LoopPods(model, device))


def make_production_mesh(*, data: int = 1, model: int = 1, group=None,
                         device: DeviceLike = None) -> Pods:
    """The grid over the initialised ``torch.distributed`` process group
    (``DistPods``): one rank a (pod, data, model) cell, ranks laid out
    row-major with ``model`` fastest, so the pods number ``world / (data *
    model)``.  On the rank's GPU unless ``device="cpu"`` (gloo), and it
    raises when there is no GPU.  With ``data == model == 1`` the pod axis
    is ``group`` (default: the world) itself; otherwise ``group`` must be
    None and one process subgroup is made for each line of each axis (every
    rank takes part in making every subgroup, as ``new_group`` needs).  An
    axis of size 1 is a ``LoopPods(1)``."""
    device = resolve_device(device)
    if data == 1 and model == 1:
        return DistPods(group, device=device)
    import torch.distributed as dist
    if group is not None:
        raise ValueError("a grid with data or model axes spans the world")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh: call torch.distributed."
                           "init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % (data * model):
        raise ValueError(f"world {world} is not pods x {data} x {model}")
    shape = {"pod": world // (data * model), "data": data, "model": model}
    strides = {"pod": data * model, "data": model, "model": 1}
    axes = {}
    for name in ("pod", "data", "model"):
        # every line of this axis: the ranks that differ only in it
        others = [r for r in range(world) if (r // strides[name]) % shape[name] == 0]
        mine = None
        for first in others:
            ranks = [first + i * strides[name] for i in range(shape[name])]
            grp = dist.new_group(ranks) if shape[name] > 1 else None
            if rank in ranks:
                mine = grp
        axes[name] = (DistPods(mine, device=device) if shape[name] > 1
                      else LoopPods(1, device))
    return axes["pod"].with_axes(data=axes["data"], model=axes["model"])
