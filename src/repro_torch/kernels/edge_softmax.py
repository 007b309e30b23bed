"""``edge_softmax_normalize``: phase 2 of the GAT edge softmax (CUDA, ``sm_90a``).

    out[e, h] = scores[e, h] / sums[dst[e], h]   if dst[e] ≥ 0 and that sum > 1e-10, else 0

The port's counterpart of the Pallas TPU kernel
``repro.kernels.edge_softmax.edge_softmax_normalize``.  The TPU kernel gathers
each edge's destination sum as a transposed one-hot matmul over block-CSR
tiles; the CUDA kernel does one indexed load of the sums per edge (one
thread per edge, vector accesses for H in 1, 2, 4, 8) and keeps the caller's
edge order.  Kernel source and its note on what bounds it:
``repro_torch/csrc/edge_softmax.cu``.  Phase 1 (``sums``) is
``segment_spmm``; :func:`repro_torch.kernels.ops.edge_softmax` composes the
two.  No main path of the port calls it.

:func:`edge_softmax_normalize` dispatches on the device of ``scores``: CPU
tensors go to :func:`edge_softmax_normalize_plain`, CUDA tensors to the
kernel, anything else raises.  ``dst`` must lie in ``[-1, R)`` for ``R =
sums.shape[0]``; the op checks that on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _fake
from repro_torch.kernels._build import I64, PTR, CudaKernel
from repro_torch.kernels.segment_spmm import _same_device

#: int fn(const float* scores, const I* dst, const float* sums, float* out,
#:        long long e, long long h, void* stream)
ARGTYPES = (PTR, PTR, PTR, PTR, I64, I64, PTR)
KERNEL = CudaKernel("edge_softmax", {"edge_softmax_normalize_i32": ARGTYPES,
                                     "edge_softmax_normalize_i64": ARGTYPES})


def edge_softmax_normalize_plain(scores: torch.Tensor, dst: torch.Tensor,
                                 sums: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the same gather and division, elementwise."""
    dst = dst.long()
    denom = torch.where((dst >= 0)[:, None], sums[dst.clamp(min=0)], 0.0)
    live = denom > 1e-10
    return torch.where(live, scores / torch.where(live, denom, 1.0), 0.0)


def edge_softmax_normalize(scores: torch.Tensor, dst: torch.Tensor,
                           sums: torch.Tensor) -> torch.Tensor:
    """``[E, H]`` scores, ``[E]`` destinations, ``[R, H]`` sums → ``[E, H]``."""
    if (scores.dim() != 2 or dst.dim() != 1 or sums.dim() != 2
            or dst.shape[0] != scores.shape[0] or sums.shape[1] != scores.shape[1]):
        raise ValueError(f"expected scores [E, H], dst [E], sums [R, H], got "
                         f"{tuple(scores.shape)}, {tuple(dst.shape)}, {tuple(sums.shape)}")
    if isinstance(scores, _fake.FakeTensor):
        out = torch.empty_like(scores)
        # one division an entry; each edge reads its destination's sums row
        _fake.report("edge_softmax_normalize", float(scores.numel()),
                     _fake.nbytes(scores, dst, scores, out))
        return out
    dev = scores.device
    if dev.type == "cpu":
        _same_device(dev, dst, sums)
        return edge_softmax_normalize_plain(scores, dst, sums)
    if dev.type != "cuda":
        raise ValueError(f"edge_softmax_normalize: unsupported device {dev}")
    _same_device(dev, dst, sums)
    if scores.dtype != torch.float32 or sums.dtype != torch.float32:
        raise ValueError(f"scores and sums must be float32, got {scores.dtype}, {sums.dtype}")
    if dst.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"dst must be int32/int64, got {dst.dtype}")
    if not (scores.is_contiguous() and dst.is_contiguous() and sums.is_contiguous()):
        raise ValueError("scores, dst and sums must be contiguous")
    e, h = scores.shape
    out = torch.empty_like(scores)
    if out.numel() == 0:
        return out
    sym = "edge_softmax_normalize_i32" if dst.dtype == torch.int32 else \
        "edge_softmax_normalize_i64"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(sym, scores.data_ptr(), dst.data_ptr(), sums.data_ptr(), out.data_ptr(),
                      e, h, stream)
    return out
