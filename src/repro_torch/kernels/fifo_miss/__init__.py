from .ops import (BACKENDS, default_backend, densify, fifo_miss, fifo_miss_ids,
                  seed_fill, stage)
from .ref import fifo_miss_ref

__all__ = ["BACKENDS", "default_backend", "densify", "fifo_miss",
           "fifo_miss_ids", "fifo_miss_ref", "seed_fill", "stage"]
