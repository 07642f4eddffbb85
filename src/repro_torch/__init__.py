"""GreenScale on PyTorch + CUDA: the port of ``src/repro`` to one NVIDIA H100.

Mirrors the reference layout (``configs``, ``core``, ``serve``, ``models``,
``kernels``, ``launch``). Imports torch and numpy only; the JAX package is
the reference the tests compare against.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
