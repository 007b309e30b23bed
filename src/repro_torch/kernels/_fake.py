"""The kernel wrappers' fake route: what a launch would allocate, and no launch.

Each wrapper takes this route when its input is a ``FakeTensor`` (whatever
its device), before any ``data_ptr()``, ``torch.cuda`` call or host read: it
allocates exactly what its CUDA route allocates (outputs, ``lse``, scratch),
with the same shapes and dtypes, and reports the call's FLOPs and bytes to
the active :class:`repro_torch.launch.op_analysis.OpAnalysis`, if any.  A
real tensor never takes it.  The dry run (:mod:`repro_torch.launch.dryrun`)
runs the port's steps this way at production shapes.

The counts are the ones behind each kernel's bound in ``PERF.md``: each
input read once, each output written once, and the mathematical FLOPs (a
product's 2 · M · N · K; one add a record element; not the split-TF32
operations).  A row schedule's live records are data, which a fake tensor
has not; every scheduled record is counted live.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["FakeTensor", "nbytes", "report", "visible_pairs"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def report(name: str, flops: float, nbytes_: float) -> None:
    from repro_torch.launch.op_analysis import report_kernel

    report_kernel(name, flops, nbytes_)


def visible_pairs(sq: int, sk: int, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs a head's attention scores: query i at ``i +
    q_offset`` sees keys ``k ≤ qpos`` (causal) and ``k > qpos − window``."""
    if not causal and window is None:
        return sq * sk
    qpos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())
