"""Benchmarks of the port that drive its serving path (``serving_coherence``)."""
