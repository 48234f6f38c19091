"""FIFO TLB miss extraction over a whole access stream.

The batched access engine's pass 1 (``repro_torch.core.batch._general_vec``)
replays the FIFO fill discipline over the stream to extract the ordered miss
list: an entry filled at fill number ``f`` is live while
``f >= fills_so_far - capacity``, so classification needs only the last fill
number per vpn and a running fill count.

Two entry points:

* ``fifo_miss(arr, initial, capacity, *, backend=None)`` takes and returns
  numpy, as the engine calls it.  Its backend is picked per call or by
  ``REPRO_FIFO_MISS_BACKEND``:

  - ``"numpy"`` (default) — the engine's original dict loop;
  - ``"cuda"`` — densify the vpns with ``np.unique`` (the TLB's keys and the
    stream share one id space), seed the fill vector from the TLB's fill
    order, and run the scan as one kernel launch on the card
    (``csrc/fifo_miss.cu``) through ``fifo_miss_ids``.  It raises where there
    is no card, and never gives way to numpy.

  Integer-only, so both give the same flags.
* ``fifo_miss_ids(fill0, nfill0, ids, capacity)`` works on the densified
  tensors: a CUDA tensor launches the kernel or raises, a CPU tensor takes
  the plain version (``ref.py``).  ``fifo_miss_ids.launches`` counts kernel
  launches.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Iterable, Optional

import numpy as np
import torch

from ... import _device
from .. import _build
from .ref import fifo_miss_ref

__all__ = ["BACKENDS", "default_backend", "densify", "fifo_miss",
           "fifo_miss_ids"]

BACKENDS = ("numpy", "cuda")

#: sentinel fill number that always classifies as a miss in the dict loop
_NEG = -1 << 40
_INT32_LIMIT = 1 << 31

_P, _I = ctypes.c_void_p, ctypes.c_int


def default_backend() -> str:
    """Backend used when the call doesn't pick one: the
    ``REPRO_FIFO_MISS_BACKEND`` env var, else ``"numpy"``."""
    return os.environ.get("REPRO_FIFO_MISS_BACKEND", "numpy")


def fifo_miss(arr: np.ndarray, initial: Iterable[int], capacity: int, *,
              backend: Optional[str] = None) -> np.ndarray:
    """Classify every access of ``arr`` against a FIFO TLB.

    ``initial`` is the TLB's current contents in fill (insertion) order;
    ``capacity`` its entry count.  Returns a bool array over ``arr``: True
    where the access misses (and therefore fills).  A vpn can miss more than
    once — each fill restarts its lifetime — which is exactly what the
    fill-number recurrence captures.
    """
    if backend is None:
        backend = default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"pick from {BACKENDS}")
    arr = np.asarray(arr, dtype=np.int64).ravel()
    if backend == "cuda":
        return _fifo_miss_cuda(arr, initial, int(capacity))
    return _fifo_miss_numpy(arr, initial, int(capacity))


def _fifo_miss_numpy(arr: np.ndarray, initial: Iterable[int],
                     capacity: int) -> np.ndarray:
    """The engine's original pass-1 dict loop, emitting a mask."""
    fillno = {}
    for p, v in enumerate(initial):
        fillno[v] = p
    nfill = len(fillno)
    out = np.zeros(arr.size, dtype=bool)
    fg = fillno.get
    for k, vpn in enumerate(arr.tolist()):
        if fg(vpn, _NEG) < nfill - capacity:
            fillno[vpn] = nfill
            nfill += 1
            out[k] = True
    return out


def densify(arr: np.ndarray, initial: Iterable[int], capacity: int):
    """The vpns as dense ids: ``(fill0 [U] int32, n0, ids [n] int32)``.

    ``np.unique`` over the TLB's keys and the stream gives one id space; the
    TLB's vpns hold fill numbers 0..n0-1, every other id starts at a
    sentinel that always classifies as a miss
    (nfill - capacity >= -capacity > -(capacity + 1), int32-safe)."""
    init = np.fromiter(initial, dtype=np.int64)
    n0 = init.size
    keys = np.concatenate([init, arr]) if n0 else arr
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = np.asarray(inv, dtype=np.int32).ravel()
    fill0 = np.full(uniq.size, -(capacity + 1), dtype=np.int32)
    fill0[inv[:n0]] = np.arange(n0, dtype=np.int32)
    return fill0, n0, inv[n0:]


def _fifo_miss_cuda(arr: np.ndarray, initial: Iterable[int],
                    capacity: int) -> np.ndarray:
    device = _device.resolve_device(None)
    fill0, n0, ids = densify(arr, initial, capacity)
    mask = fifo_miss_ids(torch.from_numpy(fill0).to(device), n0,
                         torch.from_numpy(ids).to(device), capacity)
    return mask.cpu().numpy()


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("fifo_miss").fifo_miss_launch
    fn.argtypes = [_P, _I, _I, _P, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _shared_ids(device_index: int) -> int:
    """How many ids the kernel keeps in shared memory on this device."""
    fn = _build.load("fifo_miss").fifo_miss_shared_ids
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = _I
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check_launch("fifo_miss_shared_ids", fn(ctypes.byref(out)))
    return out.value


def fifo_miss_ids(fill0: torch.Tensor, nfill0: int, ids: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """fill0: [U] int32 seed fill numbers; nfill0: the fill count before the
    stream; ids: [n] int32 in 0..U-1.  Returns the miss flags [n] bool on
    ``ids``' device.  Arithmetic is int32, as in the reference's scan, so a
    stream whose fill count could reach 2^31 is refused."""
    n, nfill0, capacity = ids.numel(), int(nfill0), int(capacity)
    if nfill0 < 0 or capacity < 0:
        raise ValueError("fifo_miss: the fill count and capacity are >= 0")
    if nfill0 + n >= _INT32_LIMIT or capacity + 1 >= _INT32_LIMIT:
        raise OverflowError(f"fifo_miss: {nfill0} fills + {n} accesses or "
                            f"capacity {capacity} leave int32")
    if fill0.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError("fifo_miss: fill0 and ids are int32")
    if fill0.dim() != 1 or ids.dim() != 1:
        raise ValueError("fifo_miss: fill0 and ids are 1-d")
    if not ids.is_cuda:
        return fifo_miss_ref(fill0, nfill0, ids, capacity)
    if not (fill0.is_cuda and fill0.device == ids.device):
        raise ValueError("fifo_miss: operands must be on one CUDA device")
    dev = ids.device
    fill0 = fill0.contiguous()
    if not ids.is_contiguous() or ids.data_ptr() % 16:
        ids = ids.clone()      # the kernel loads ids 16 bytes at a time
    U = fill0.numel()
    mask = torch.empty((n,), dtype=torch.uint8, device=dev)
    if n == 0:                  # nothing to classify: no launch
        return mask.view(torch.bool)
    scratch = (None if U <= _shared_ids(dev.index)
               else torch.empty((U,), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        code = _launcher()(
            fill0.data_ptr(), U, nfill0, ids.data_ptr(), n, capacity,
            None if scratch is None else scratch.data_ptr(), mask.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("fifo_miss", code)
    fifo_miss_ids.launches += 1
    return mask.view(torch.bool)


fifo_miss_ids.launches = 0
