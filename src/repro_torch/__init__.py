"""numaPTE serving substrate in PyTorch + CUDA (the port of ``repro``).

Same sub-package layout as the JAX package (``kernels/<name>/``, ``pagedpt``,
``kvcache``, ``models``, ``configs``, ``launch``).  Imports ``torch`` and
numpy only.  Entry points run on the GPU: ``device=None`` resolves to
``cuda`` and raises when there is none; the CPU is used only when the caller
passes ``device="cpu"``.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
