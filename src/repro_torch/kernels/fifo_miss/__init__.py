from .ops import BACKENDS, default_backend, densify, fifo_miss, fifo_miss_ids
from .ref import fifo_miss_ref

__all__ = ["BACKENDS", "default_backend", "densify", "fifo_miss",
           "fifo_miss_ids", "fifo_miss_ref"]
