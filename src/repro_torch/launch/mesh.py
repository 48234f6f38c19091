"""The pod axis a run builds, in place of the reference's device meshes.

The reference's ``make_production_mesh`` / ``make_debug_mesh`` build
``jax.make_mesh`` meshes whose ``pod`` axis carries pure data parallelism
plus the numaPTE block-table coherence domain (and a ``data`` x ``model``
grid inside each pod).  The port builds the pod axis alone
(``repro_torch.distributed.pods``); the in-pod ``model`` axis is ROADMAP
queue 1 item 16.  Both are functions, so importing this module touches no
device or process group.
"""
from __future__ import annotations

from .._device import DeviceLike
from ..distributed.pods import DistPods, LoopPods, Pods


def make_debug_mesh(n_pods: int = 4, *, device: DeviceLike = None) -> Pods:
    """``n_pods`` pods in this process (``LoopPods``): the multi-pod path on
    one device, the GPU unless ``device="cpu"``."""
    return LoopPods(n_pods, device)


def make_production_mesh(*, group=None, device: DeviceLike = None) -> Pods:
    """One pod a rank of the initialised ``torch.distributed`` process group
    (``DistPods``): on the rank's GPU unless ``device="cpu"`` (gloo), and it
    raises when there is no GPU."""
    return DistPods(group, device=device)
