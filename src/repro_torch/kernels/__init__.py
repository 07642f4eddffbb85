"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers
(``ops``), plain versions (``ref``) and the nvcc/ctypes builder (``build``)."""
