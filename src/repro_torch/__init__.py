"""PyTorch/CUDA port of the incremental GNN embedding engine.

A second package beside the JAX reference ``repro``, with the same module
names (``repro_torch.core.full`` ↔ ``repro.core.full``, …).  It imports
``torch`` and ``numpy`` and nothing of ``jax`` or ``repro``.  The TPU kernels
on its path are hand-written CUDA C++ for Hopper (``repro_torch/csrc``),
built with ``nvcc`` at first use.  Entry points run on ``cuda`` unless the
caller asks for the CPU.
"""

import torch as _torch

# A fault of PyTorch's CPU build (seen with torch 2.13.0+cpu and its bundled
# oneAPI MKL 2024.2): the first ``torch.sqrt`` of a process that runs on
# several OpenMP threads at once can give one thread's share of the elements
# at about 12 bits (sqrt(2.0) = 1.413818359375), then never again.  One
# serial call on the importing thread first, too small to split across
# threads, keeps the later parallel calls exact (ROADMAP.md Queue 3 item 5;
# tests/test_torch_cpu_sqrt.py).
_torch.sqrt(_torch.full((16,), 2.0))
