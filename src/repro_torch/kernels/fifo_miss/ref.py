"""Plain PyTorch version of the FIFO-TLB miss scan over densified ids.

The step of the reference's ``lax.scan`` (``_jit_scan``): carry the fill
vector and the fill count; an access to id ``i`` misses where
``fill[i] < nfill - capacity``, and a miss stores ``fill[i] = nfill`` and
counts one more fill.  The scan is sequential, so it walks Python ints taken
from the tensors: one tensor operation a step would cost microseconds each.
"""
from __future__ import annotations

import torch


def fifo_miss_ref(fill0: torch.Tensor, nfill0: int, ids: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """fill0: [U] int32 seed fill numbers (the TLB's ids hold 0..n0-1 in fill
    order, every other id the sentinel ``-(capacity + 1)``); nfill0: the fill
    count before the stream; ids: [n] int32 in 0..U-1.  Returns the miss flag
    of every access, [n] bool on ``ids``' device; ``fill0`` is not written."""
    U = fill0.numel()
    if ids.numel() and not (0 <= int(ids.min()) and int(ids.max()) < U):
        raise IndexError(f"fifo_miss: an id lies outside 0..{U - 1}")
    fill = fill0.tolist()
    nfill = int(nfill0)
    out = []
    for i in ids.tolist():
        miss = fill[i] < nfill - capacity
        if miss:
            fill[i] = nfill
            nfill += 1
        out.append(miss)
    return torch.tensor(out, dtype=torch.bool, device=ids.device)
