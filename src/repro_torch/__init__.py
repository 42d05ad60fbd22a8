"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The layout follows ``src/repro/`` module for module, so the counterpart of
``repro/models/attention.py`` is ``repro_torch/models/attention.py``. The
port imports ``torch`` only: it never imports ``jax`` or ``repro``, and keeps
its own copies of the framework-free modules it needs (``configs/base.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.py``). Kernels that were Pallas TPU kernels in ``repro`` are
hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc/``.
"""
