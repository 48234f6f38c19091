from .pipeline import SyntheticLMDataset, make_batch_iterator

__all__ = ["SyntheticLMDataset", "make_batch_iterator"]
