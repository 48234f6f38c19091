"""The import check: no process of the benchmark may load JAX, Flax or the
JAX package ``repro`` (the port, ``repro_torch``, is allowed).  Module names
are compared by their top-level part, the text before the first dot, whole.
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded (or given) module names whose top level is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
