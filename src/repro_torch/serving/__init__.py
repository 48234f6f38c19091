"""Closed-loop serving over the NumaSim mm engine.

``repro_torch.serving.loop`` turns the paper's shootdown-contention mechanism
into the latency distributions an inference stack cares about: Poisson
request arrivals drive a ``PagedKVManager``-shaped KV-block
alloc/extend/free churn whose table mutations run through
``apply_mm_ops`` on a multi-tenant ``NumaSim``, and per-request latency
is assembled from the modeled thread clocks.
"""
from .loop import (KVChurnAdapter, Request, SERVING_POLICIES,
                   nominal_capacity_rps, poisson_trace, run_closed_loop)

__all__ = ["KVChurnAdapter", "Request", "SERVING_POLICIES",
           "nominal_capacity_rps", "poisson_trace", "run_closed_loop"]
