"""Public wrapper for the device page walk: mutation drain + walk + prefetch
window in one kernel launch.

A CUDA tensor launches the hand-written kernel (``csrc/pte_gather.cu``) or
raises; only a CPU tensor takes the plain PyTorch version.
``pte_gather.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from .ref import pte_gather_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_MUTATION_DTYPES = (torch.int32, torch.int32, torch.int32, torch.bool)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("pte_gather").pte_gather_launch
    fn.argtypes = [_P] * 9 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def pte_gather(entries: torch.Tensor, logical: torch.Tensor,
               prefetch_degree: int,
               mutations: Optional[Sequence[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """entries: [T, epb] int32 packed PTEs; logical: [M] int32 ids;
    mutations: None or (table, idx, value [n] int32, applied [n] bool) in
    program order, applied to ``entries`` in place before the walk (the last
    applied mutation of a slot wins; entries not applied write nothing).
    Returns (frames [M] i32, present [M] bool, window [M, 2^d] i32 raw
    entries)."""
    T, epb = entries.shape
    W = 1 << prefetch_degree
    if W > epb:
        raise ValueError(f"pte_gather: window {W} wider than a table page {epb}")
    if mutations is not None:
        mutations = tuple(mutations)
        n = mutations[0].shape[0]
        if (len(mutations) != 4
                or any(m.shape != (n,) for m in mutations)
                or tuple(m.dtype for m in mutations) != _MUTATION_DTYPES):
            raise TypeError("pte_gather: mutations are (table, idx, value) "
                            "int32 and applied bool, all of one length")
    if not entries.is_cuda:
        return pte_gather_ref(entries, logical, prefetch_degree, mutations)
    (M,) = logical.shape
    muts = mutations if mutations is not None and mutations[0].numel() else ()
    if entries.dtype != torch.int32 or logical.dtype != torch.int32:
        raise TypeError("pte_gather: entries and logical are int32")
    if not all(t.is_cuda and t.device == entries.device and t.is_contiguous()
               for t in (entries, logical, *muts)):
        raise ValueError("pte_gather: operands must be contiguous and on one "
                         "CUDA device")
    dev = entries.device
    frames = torch.empty((M,), dtype=torch.int32, device=dev)
    present = torch.empty((M,), dtype=torch.bool, device=dev)
    window = torch.empty((M, W), dtype=torch.int32, device=dev)
    if M == 0 and not muts:          # nothing to drain or walk: no launch
        return frames, present, window
    mut_ptrs = [m.data_ptr() for m in muts] or [None] * 4
    with torch.cuda.device(dev):
        code = _launcher()(
            entries.data_ptr(), logical.data_ptr(), *mut_ptrs,
            frames.data_ptr(), present.data_ptr(), window.data_ptr(),
            T, epb, W, M, len(muts[0]) if muts else 0,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("pte_gather", code)
    pte_gather.launches += 1
    return frames, present, window


pte_gather.launches = 0
