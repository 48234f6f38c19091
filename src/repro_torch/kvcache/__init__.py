from .manager import PagedKVManager, ServingStats

__all__ = ["PagedKVManager", "ServingStats"]
