"""Public wrapper for paged decode attention.

A CUDA tensor launches the hand-written kernel
(``csrc/paged_attention.cu``) or raises; only a CPU tensor takes the plain
PyTorch version.  ``paged_attention.launches`` counts kernel launches, one a
call, and ``paged_attention.softcap_launches`` those of them with a cap.

The kernel splits each sequence's block-table columns across blocks
(split-KV).  ``_split_plan`` picks the split from shapes alone, so the
wrapper never reads ``seq_lens`` (or any device tensor) on the host; the
partial results are merged inside the same launch.  With ``lse`` the
kernel also writes each row's log-sum-exp (for the sequence-parallel
combine); serving passes none and the kernel writes nothing.  With
``kv_heads=(first, count)`` the kernel attends over ``count`` kv heads of a
contiguous slab that holds K, starting at ``first`` (a model shard's heads of
the replicated slab): it strides over the slab's K heads a slot, and nothing
is copied.  ``softcap`` = c caps the scaled scores, ``c * tanh(s / c)``
(the reference's logit soft-cap), in a kernel instance of its own: the
launch without a cap runs the instance it ran before.

``mla_decode`` is the paged latent-attention decode (K4, MLA): one latent
slab a layer, every head reading the same latent of a slot, V its first
``dv`` columns; ``mla_decode.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from .ref import mla_decode_ref, paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the kernel's block shape and limits (csrc/paged_attention.cu, which
# rejects a plan past MAX_SPLITS or MAX_COLS)
GROUP = 16          # query heads a block: the M of one mma
TILE = 16           # token slots a tile
WARPS = 4           # warps a block, each walking its own tiles
MAX_SPLITS = 256
MAX_COLS = 512      # block-table columns a split (staged in shared memory)


def _window_span(MB: int, bt: int, window: Optional[int]) -> int:
    """Block-table columns a row's live slots can touch: all MB, or at most
    ceil((window - 1) / bt) + 1 for a window of that many positions."""
    if window is None:
        return MB
    return max(1, min(MB, -(-(window - 1) // bt) + 1))


def _split_plan(B: int, K: int, G: int, MB: int, bt: int,
                window: Optional[int], slots: int) -> Tuple[int, int, int]:
    """(n_gc, n_splits, cols_per_split) from shapes alone.

    n_gc groups of up to ``GROUP`` query heads share a kv head's tiles; the
    columns a row can use are cut into n_splits ranges of cols_per_split, as
    many as fit the B * K * n_gc * n_splits blocks into one wave of
    ``slots`` (the blocks all SMs hold at once), but no fewer than two tiles
    a warp each and no more than ``MAX_COLS`` columns a split."""
    n_gc = -(-G // GROUP)
    span = _window_span(MB, bt, window)
    min_cols = max(1, -(-2 * WARPS * TILE // bt))
    want = slots // max(1, B * K * n_gc)
    n_splits = max(1, min(want, -(-span // min_cols), MAX_SPLITS),
                   -(-span // MAX_COLS))
    cps = -(-span // n_splits)
    return n_gc, -(-span // cps), cps


@functools.lru_cache(maxsize=None)
def _plan(index: int, dtype: int, B: int, H: int, K: int, hd: int, MB: int,
          bt: int, window: Optional[int], capped: bool = False
          ) -> Tuple[int, int, int]:
    """``_split_plan`` for device ``index``: one wave is its SMs times the
    blocks of the kernel for (hd, dtype, capped) that one SM holds."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        fn = _build.load("paged_attention").paged_attention_blocks_per_sm
        fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = _I
        _build.check_launch("paged_attention", fn(hd, dtype, int(capped),
                                                  ctypes.byref(blocks)))
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = _split_plan(B, K, H // K, MB, bt, window, sms * max(1, blocks.value))
    if B * K * plan[0] >= 2 ** 31 or plan[1] > MAX_SPLITS:
        raise ValueError(f"paged_attention: B {B} x K {K} or {MB} columns "
                         "exceed the grid")
    return plan


# per (device, stream): the combine's counters and its partials
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(index: int, stream: int, n_counters: int,
             n_partials: int) -> Tuple[int, int]:
    """Addresses of ``n_counters`` int32 counters, 0 between launches (the
    last block of each group resets its own, and no other data ever lands
    there), and of ``n_partials`` float32 partials.  Launches on one stream
    run in order and share them; launches on two streams never do."""
    counters, partials = _SCRATCH.get((index, stream), (None, None))
    device = torch.device("cuda", index)
    grow = (counters is None or counters.numel() < n_counters
            or partials.numel() < n_partials)
    if grow and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("paged_attention: a CUDA graph's capture stream "
                           "needs its scratch made before the capture (run "
                           "the step once on that stream first)")
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 1 << 12), dtype=torch.int32,
                               device=device)
    if partials is None or partials.numel() < n_partials:
        partials = torch.empty(max(n_partials, 1 << 16), dtype=torch.float32,
                               device=device)
    _SCRATCH[(index, stream)] = (counters, partials)
    return counters.data_ptr(), partials.data_ptr()


def stream_scratch(index: int, stream: int) -> Tuple[torch.Tensor, ...]:
    """The scratch tensors of (device, stream), which a CUDA graph captured
    on that stream keeps alive: its launches read their addresses."""
    return _SCRATCH.get((index, stream), ())


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = [_P] * 9 + [_I] * 13 + [_F, _P]
    fn.restype = _I
    return fn


def paged_attention(q: torch.Tensor, k_slabs: torch.Tensor,
                    v_slabs: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    window: Optional[int] = None,
                    lse: Optional[torch.Tensor] = None,
                    kv_heads: Optional[Tuple[int, int]] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: [B,H,hd]; k/v_slabs: [N,bt,K,hd] (one layer's slabs); block_tables:
    [B,MB] int32 physical frames (-1 absent); seq_lens: [B] int32, including
    the newest token (a length <= 0 leaves the row with no live slot).
    Returns [B,H,hd] float32.  A row with no live block returns zeros.
    ``lse``: None, or a float32 [B,H] tensor into which each row's
    ln sum exp(scale q.k) over its live slots is written (``NEG_INF`` for a
    row with none).  ``softcap``: the logit cap c (None: none)."""
    B, H, hd = q.shape
    if softcap is not None and softcap < 0:
        raise ValueError(f"paged_attention: softcap {softcap}: a cap is "
                         "positive")
    cap = float(softcap or 0.0)
    if lse is not None and (lse.shape != (B, H) or lse.dtype != torch.float32
                            or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError("paged_attention: lse must be a contiguous float32 "
                         f"[B, H] tensor on q's device, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    K_slab = k_slabs.shape[2]
    kv0, K = kv_heads if kv_heads is not None else (0, K_slab)
    if kv0 < 0 or K < 1 or kv0 + K > K_slab:
        raise ValueError(f"paged_attention: kv heads {kv_heads} of a slab "
                         f"with {K_slab}")
    if not q.is_cuda:
        if lse is None:
            return paged_attention_ref(q, k_slabs, v_slabs, block_tables,
                                       seq_lens, window=window,
                                       kv_heads=kv_heads, softcap=cap)
        out, row_lse = paged_attention_ref(q, k_slabs, v_slabs, block_tables,
                                           seq_lens, window=window,
                                           return_lse=True, kv_heads=kv_heads,
                                           softcap=cap)
        lse.copy_(row_lse)
        return out
    N, bt, _, hd2 = k_slabs.shape
    MB = block_tables.shape[1]
    if (q.dtype not in _DTYPES or k_slabs.dtype != q.dtype
            or v_slabs.dtype != q.dtype):
        raise TypeError("paged_attention: q and slabs must share float32 or "
                        f"bfloat16, got {q.dtype}/{k_slabs.dtype}/{v_slabs.dtype}")
    if (hd2 != hd or v_slabs.shape != k_slabs.shape or H % K or hd > 256
            or (hd * q.element_size()) % 16 or block_tables.shape[0] != B
            or seq_lens.shape != (B,) or MB == 0
            or (window is not None and window < 0)):
        raise ValueError("paged_attention: unsupported shapes "
                         f"q{tuple(q.shape)} slabs{tuple(k_slabs.shape)} "
                         f"tables{tuple(block_tables.shape)} window {window}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and seq_lens are int32")
    tensors = (q, k_slabs, v_slabs, block_tables, seq_lens)
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("paged_attention: operands must be contiguous, "
                         "16-byte aligned and on one CUDA device")
    if B == 0:                      # no sequence: no launch, no count
        return torch.empty((0, H, hd), dtype=torch.float32, device=q.device)
    index, dtype = q.device.index, _DTYPES[q.dtype]
    n_gc, n_splits, cps = _plan(index, dtype, B, H, K, hd, MB, bt, window,
                                cap > 0)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        counters = partials = 0
        if n_splits > 1:
            counters, partials = _scratch(index, stream, B * K * n_gc,
                                          B * H * n_splits * (hd + 2))
        code = _launcher()(
            q.data_ptr(), k_slabs.data_ptr(), v_slabs.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            partials, counters, None if lse is None else lse.data_ptr(),
            B, H, K, K_slab, kv0, hd, bt, MB,
            -1 if window is None else int(window), n_gc, n_splits, cps, dtype,
            cap, stream)
    _build.check_launch("paged_attention", code)
    paged_attention.launches += 1
    paged_attention.softcap_launches += cap > 0
    return out


paged_attention.launches = 0
paged_attention.softcap_launches = 0   # the launches of the capped instance


# ------------------------------------------------------------ latent (K4)
#: (latent width dv, rope width) pairs K4 has an instance for: Moonlight's
#: (DeepSeek-V3's too)
MLA_WIDTHS = ((512, 64),)
MLA_HEADS = 16      # query heads a block: the N of its wgmma
MLA_SLOTS = 64      # slots a stage: the M of its wgmma; bt divides it


def _mla_split_plan(B: int, MB: int, bt: int, slots: int) -> int:
    """K4's n_splits from shapes alone: the blocks that share each row's
    live columns, as many as fit B of them into one wave of ``slots``
    resident blocks, but no more than two stages' columns a split of the
    whole table allows, nor ``MAX_SPLITS``.  The kernel cuts each row's
    ceil(len / bt) live columns into n_splits ranges on the device."""
    min_cols = max(1, 2 * MLA_SLOTS // bt)
    want = slots // max(1, B)
    return max(1, min(want, -(-MB // min_cols), MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _mla_plan(index: int, B: int, MB: int, bt: int, dv: int, dr: int) -> int:
    """``_mla_split_plan`` for device ``index``: one wave is its SMs times
    the blocks of K4's (dv, dr) instance that one SM holds."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        fn = _build.load("paged_attention").mla_decode_blocks_per_sm
        fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
        fn.restype = _I
        _build.check_launch("paged_attention", fn(dv, dr, ctypes.byref(blocks)))
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _mla_split_plan(B, MB, bt, sms * max(1, blocks.value))


@functools.lru_cache(maxsize=None)
def _mla_launcher():
    fn = _build.load("paged_attention").mla_decode_launch
    fn.argtypes = [_P] * 7 + [_I] * 8 + [_F, _P]
    fn.restype = _I
    return fn


def mla_decode(q: torch.Tensor, slab: torch.Tensor, block_tables: torch.Tensor,
               seq_lens: torch.Tensor, *, scale: float, dv: int
               ) -> torch.Tensor:
    """q: [B,H,dk] (H <= 16); slab: [N,bt,1,dk] (one layer's latents);
    block_tables: [B,MB] int32 physical frames (-1 absent); seq_lens: [B]
    int32, the newest token included.  Returns softmax(scale q.latent) .
    latent[..., :dv] over each row's live slots, [B,H,dv] float32 (zeros
    for a row with none).  bfloat16 on the card (the widths of
    ``MLA_WIDTHS``, bt a divisor of ``MLA_SLOTS`` from 8 up); a CPU tensor
    takes the plain version."""
    B, H, dk = q.shape
    if not q.is_cuda:
        return mla_decode_ref(q, slab, block_tables, seq_lens, scale=scale,
                              dv=dv)
    N, bt = slab.shape[:2]
    MB = block_tables.shape[1]
    if q.dtype != torch.bfloat16 or slab.dtype != q.dtype:
        raise TypeError("mla_decode: q and the slab are bfloat16, got "
                        f"{q.dtype}/{slab.dtype}")
    if ((dv, dk - dv) not in MLA_WIDTHS or slab.shape[2:] != (1, dk)
            or H > MLA_HEADS or block_tables.shape[0] != B
            or seq_lens.shape != (B,) or MB == 0 or N == 0
            or bt < 8 or MLA_SLOTS % bt):
        raise ValueError("mla_decode: unsupported shapes "
                         f"q{tuple(q.shape)} slab{tuple(slab.shape)} "
                         f"tables{tuple(block_tables.shape)} dv {dv}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("mla_decode: block_tables and seq_lens are int32")
    tensors = (q, slab, block_tables, seq_lens)
    if not all(t.is_cuda and t.device == q.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("mla_decode: operands must be contiguous, 16-byte "
                         "aligned and on one CUDA device")
    if B == 0:
        return torch.empty((0, H, dv), dtype=torch.float32, device=q.device)
    index = q.device.index
    n_splits = _mla_plan(index, B, MB, bt, dv, dk - dv)
    out = torch.empty((B, H, dv), dtype=torch.float32, device=q.device)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        counters = partials = 0
        if n_splits > 1:
            counters, partials = _scratch(index, stream, B,
                                          B * MLA_HEADS * n_splits * (dv + 2))
        code = _mla_launcher()(
            q.data_ptr(), slab.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), partials, counters,
            B, H, dv, dk - dv, bt, MB, N, n_splits, float(scale), stream)
    _build.check_launch("paged_attention", code)
    mla_decode.launches += 1
    return out


mla_decode.launches = 0
