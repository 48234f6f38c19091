"""Public wrappers for flash (prefill) attention and its gradient.

A CUDA tensor launches the hand-written kernels (``csrc/flash_attention.cu``
forward, ``csrc/flash_attention_bwd.cu`` backward) or raises; only a CPU
tensor takes the plain PyTorch versions.  ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count kernel launches (the backward's one
call is its three kernels: the D pre-pass, dK/dV and dQ).  bfloat16 inputs
run the forward on the tensor cores, float32 inputs on the CUDA cores; the
backward computes in float32 on the CUDA cores for both.

``flash_attention`` is differentiable: when autograd records (grad mode on
and an input requires grad) it runs as ``FlashAttentionFn``, whose forward
also writes the rows' log-sum-exp for the backward.  Otherwise (serving
runs under ``no_grad``) it launches the forward alone and passes no LSE
pointer.

The kernels read q, k and v through their (batch, head, row) strides, so
the ``[B,S,H,hd]`` projections of the model can be handed over as
transposed views without a copy; only head_dim must be contiguous.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P] * 5 + [_I] * 8 + [ctypes.POINTER(ctypes.c_int64), _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = [_P] * 10 + [_I] * 8 + [ctypes.POINTER(ctypes.c_int64), _P]
    fn.restype = _I
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(tensors)))(
        *(t.stride(d) for t in tensors for d in (0, 1, 2)))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: Optional[int], with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out [B,H,S,hd] f32, lse [B,H,S] f32 or None)."""
    if not q.is_cuda:
        if with_lse:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        return flash_attention_ref(q, k, v, causal=causal, window=window), None
    _check(q, k, v)
    B, H, S, hd = q.shape
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or S == 0:            # no row: no launch, no count
        return out, lse
    with torch.cuda.device(q.device):
        code = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, k.shape[1], S, hd, int(bool(causal)),
            -1 if window is None else int(window), _DTYPES[q.dtype],
            _strides(q, k, v, out), torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention", code)
    flash_attention.launches += 1
    return out, lse


def _vec4(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the backward can read it four elements at a time (head_dim
    contiguous, 16-byte aligned, strides multiples of 4), else a copy."""
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(d) % 4 == 0 for d in (0, 1, 2))):
        return t
    return t.contiguous()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention`` from its forward's ``out`` and
    ``lse`` and the output gradient ``dout`` [B,H,S,hd]: (dq [B,H,S,hd],
    dk, dv [B,K,S,hd]), float32."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                       window=window)
    _check(q, k, v)
    B, H, S, hd = q.shape
    K = k.shape[1]
    if (out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, H, S) or out.dtype != torch.float32
            or lse.dtype != torch.float32 or not lse.is_contiguous()
            or not all(t.device == q.device for t in (out, lse, dout))):
        raise ValueError("flash_attention_bwd: out and dout must be "
                         "[B,H,S,hd] and lse [B,H,S] contiguous, float32, on "
                         "q's device")
    q, k, v, out = (_vec4(t) for t in (q, k, v, out))
    dout = _vec4(dout.float())
    dq = torch.empty_like(q, dtype=torch.float32)
    dk = torch.empty_like(k, dtype=torch.float32)
    dv = torch.empty_like(v, dtype=torch.float32)
    if B == 0 or S == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, K, S, hd, int(bool(causal)),
            -1 if window is None else int(window), _DTYPES[q.dtype],
            _strides(q, k, v, out, dout, dq, dk, dv),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("flash_attention_bwd", code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward keeps q, k, v, the
    output and the rows' log-sum-exp; the backward runs
    ``flash_attention_bwd`` and casts each gradient to its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B,H,S,hd]; k,v: [B,K,S,hd] (GQA, kv head = h // (H/K)).  Returns a
    contiguous [B,H,S,hd] float32 tensor.  S is free (ragged tiles are
    masked).  Differentiable in q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, with_lse=False)[0]


flash_attention.launches = 0
flash_attention_bwd.launches = 0
