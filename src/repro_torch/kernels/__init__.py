"""Hand-written Hopper kernels, one sub-package each (``ops`` wrapper,
``ref`` plain PyTorch version) over the CUDA C++ sources in ``csrc/``."""
