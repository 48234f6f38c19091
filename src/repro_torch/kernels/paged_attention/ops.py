"""Public wrapper for paged decode attention.

A CUDA tensor launches the hand-written kernel
(``csrc/paged_attention.cu``) or raises; only a CPU tensor takes the plain
PyTorch version.  ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = [_P] * 6 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def paged_attention(q: torch.Tensor, k_slabs: torch.Tensor,
                    v_slabs: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,hd]; k/v_slabs: [N,bt,K,hd] (one layer's slabs); block_tables:
    [B,MB] int32 physical frames (-1 absent); seq_lens: [B] int32, including
    the newest token.  Returns [B,H,hd] float32.  A row with no live block
    returns zeros."""
    if not q.is_cuda:
        return paged_attention_ref(q, k_slabs, v_slabs, block_tables,
                                   seq_lens, window=window)
    B, H, hd = q.shape
    N, bt, K, hd2 = k_slabs.shape
    MB = block_tables.shape[1]
    per_lane = max(1, 1 << (-(-hd // 32) - 1).bit_length())
    if (q.dtype not in _DTYPES or k_slabs.dtype != q.dtype
            or v_slabs.dtype != q.dtype):
        raise TypeError("paged_attention: q and slabs must share float32 or "
                        f"bfloat16, got {q.dtype}/{k_slabs.dtype}/{v_slabs.dtype}")
    if (hd2 != hd or v_slabs.shape != k_slabs.shape or H % K or hd > 256
            or hd % per_lane or block_tables.shape[0] != B
            or seq_lens.shape != (B,) or K > 65535):
        raise ValueError("paged_attention: unsupported shapes "
                         f"q{tuple(q.shape)} slabs{tuple(k_slabs.shape)} "
                         f"tables{tuple(block_tables.shape)}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and seq_lens are int32")
    tensors = (q, k_slabs, v_slabs, block_tables, seq_lens)
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("paged_attention: operands must be contiguous, "
                         "16-byte aligned and on one CUDA device")
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    if B == 0:                      # no sequence: no launch, no count
        return out
    with torch.cuda.device(q.device):
        code = _launcher()(
            q.data_ptr(), k_slabs.data_ptr(), v_slabs.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, K, hd, bt, MB, -1 if window is None else int(window),
            _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check_launch("paged_attention", code)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
