from .manager import PagedKVManager

__all__ = ["PagedKVManager"]
