"""PyTorch/CUDA port of the incremental GNN embedding engine.

A second package beside the JAX reference ``repro``, with the same module
names (``repro_torch.core.full`` ↔ ``repro.core.full``, …).  It imports
``torch`` and ``numpy`` and nothing of ``jax`` or ``repro``.  The TPU kernels
on its path are hand-written CUDA C++ for Hopper (``repro_torch/csrc``),
built with ``nvcc`` at first use.  Entry points run on ``cuda`` unless the
caller asks for the CPU.
"""
