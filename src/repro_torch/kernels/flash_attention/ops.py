"""Public wrapper for flash (prefill) attention.

A CUDA tensor launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises; only a CPU tensor takes the plain
PyTorch version.  ``flash_attention.launches`` counts kernel launches.
bfloat16 inputs run on the tensor cores, float32 inputs on the CUDA cores.

The kernel reads q, k and v through their (batch, head, row) strides, so the
``[B,S,H,hd]`` projections of the model can be handed over as transposed
views without a copy; only head_dim must be contiguous.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import _build
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 8 + [ctypes.POINTER(ctypes.c_int64), _P]
    fn.restype = _I
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,S,hd]; k,v: [B,K,S,hd] (GQA, kv head = h // (H/K)).  Returns a
    contiguous [B,H,S,hd] float32 tensor.  S is free (ragged tiles are
    masked)."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, H, S, hd = q.shape
    K = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if (k.shape != (B, K, S, hd) or v.shape != k.shape or H % K or hd > 256
            or hd % 4 or H > 65535 or B > 65535):
        raise ValueError("flash_attention: unsupported shapes "
                         f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not all(t.is_cuda and t.device == q.device and t.stride(3) == 1
               and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_attention: operands must have a contiguous "
                         "head_dim, be 16-byte aligned and on one CUDA device")
    if q.dtype == torch.bfloat16 and (hd % 16 or any(
            t.stride(d) % 8 for t in (q, k, v) for d in (0, 1, 2))):
        raise ValueError("flash_attention: bfloat16 runs on the tensor cores "
                         "and needs head_dim % 16 == 0 and 16-byte aligned "
                         "batch, head and row strides")
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:            # no row: no launch, no count
        return out
    strides = (ctypes.c_int64 * 12)(*(t.stride(d) for t in (q, k, v, out)
                                      for d in (0, 1, 2)))
    with torch.cuda.device(q.device):
        code = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, S, hd, int(bool(causal)),
            -1 if window is None else int(window), _DTYPES[q.dtype], strides,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention", code)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
