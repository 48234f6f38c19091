"""Host staging for the page walk's one host-to-device copy.

Each walk packs its mutation list and logical ids into one host buffer and
sends it to the device with one ``non_blocking`` copy.  A pinned buffer must
not be written again while a copy from it may still be in flight, so the
buffers form a small ring, each guarded by a CUDA event recorded after its
copy: a buffer is reused only once its event has completed, and when every
buffer is still in flight the ring adds one instead of waiting.  A buffer too
small for a call is replaced by a larger one.  On the CPU the copy is
synchronous, buffers are not pinned and no event is needed.
"""
from __future__ import annotations

from typing import List, Optional

import torch


class StagingRing:
    def __init__(self, device: torch.device, nbytes: int = 1 << 16,
                 slots: int = 2):
        self.device = device
        self.pinned = device.type == "cuda"
        self.buffers: List[torch.Tensor] = [self._new(nbytes)
                                            for _ in range(slots)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots

    def _new(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pinned)

    def _free(self, k: int) -> bool:
        event = self.events[k]
        return event is None or event.query()

    def send(self, host_fill, nbytes: int) -> torch.Tensor:
        """Fill ``nbytes`` of a free buffer with ``host_fill(uint8 numpy
        view)`` and copy them to the device in one ``non_blocking`` copy on
        the current stream; returns the device bytes.  Never waits for the
        device."""
        k = next((k for k in range(len(self.buffers)) if self._free(k)), None)
        if k is None:                # every buffer may still be in flight
            k = len(self.buffers)
            self.buffers.append(self._new(nbytes))
            self.events.append(None)
        if self.buffers[k].numel() < nbytes:
            self.buffers[k] = self._new(max(nbytes, 2 * self.buffers[k].numel()))
        host = self.buffers[k][:nbytes]
        host_fill(host.numpy())
        dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        dev.copy_(host, non_blocking=True)
        if self.pinned:
            if self.events[k] is None:
                self.events[k] = torch.cuda.Event()
            self.events[k].record(torch.cuda.current_stream(self.device))
        return dev
