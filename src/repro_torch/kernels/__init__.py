"""Kernel layer: hand-written CUDA C++ kernels behind a dispatch registry.

- ``ops``      — public op functions (what the models call)
- ``dispatch`` — registry: op → implementation (``ref`` | ``cuda``),
  explicit ``mode=`` and ``using()`` overrides, device default
- ``ref``      — plain PyTorch versions (CPU path and on-card yardstick)
- ``build``    — nvcc build of ``csrc/*.cu`` and ctypes loading
- one wrapper module per kernel (``flash_attention``, ``flash_decode``,
  ``gae``, ``ssd``, ``quant_matmul``, ``pack``)
"""
