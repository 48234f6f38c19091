"""Public wrapper for the fused walk + prefetch kernel.

A CUDA tensor launches the hand-written kernel (``csrc/pte_gather.cu``) or
raises; only a CPU tensor takes the plain PyTorch version.
``pte_gather.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from .ref import pte_gather_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("pte_gather").pte_gather_launch
    fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


def pte_gather(entries: torch.Tensor, logical: torch.Tensor,
               prefetch_degree: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """entries: [T, epb] int32 packed PTEs; logical: [M] int32 ids.  Returns
    (frames [M] i32, present [M] bool, window [M, 2^d] i32 raw entries)."""
    if not entries.is_cuda:
        return pte_gather_ref(entries, logical, prefetch_degree)
    T, epb = entries.shape
    (M,) = logical.shape
    W = 1 << prefetch_degree
    if W > epb:
        raise ValueError(f"pte_gather: window {W} wider than a table page {epb}")
    if entries.dtype != torch.int32 or logical.dtype != torch.int32:
        raise TypeError("pte_gather: entries and logical are int32")
    if not (logical.is_cuda and logical.device == entries.device
            and entries.is_contiguous() and logical.is_contiguous()):
        raise ValueError("pte_gather: operands must be contiguous and on one "
                         "CUDA device")
    dev = entries.device
    frames = torch.empty((M,), dtype=torch.int32, device=dev)
    present = torch.empty((M,), dtype=torch.bool, device=dev)
    window = torch.empty((M, W), dtype=torch.int32, device=dev)
    if M == 0:                      # nothing to walk: no launch, no count
        return frames, present, window
    with torch.cuda.device(dev):
        code = _launcher()(
            entries.data_ptr(), logical.data_ptr(), frames.data_ptr(),
            present.data_ptr(), window.data_ptr(), T, epb, W, M,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("pte_gather", code)
    pte_gather.launches += 1
    return frames, present, window


pte_gather.launches = 0
