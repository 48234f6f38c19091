from .ops import pte_gather
from .ref import pte_gather_ref

__all__ = ["pte_gather", "pte_gather_ref"]
