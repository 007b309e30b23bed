"""``row_linear``: a dense fp32 product whose rows do not depend on the row
count (CUDA, ``sm_90a``).

    out[i, j] = Σ_{k=0}^{K-1} A[i, k] · W[k, j]     (k ascending, one accumulator)

The GNN models' message and update functions (``repro_torch.core.models``)
take every 2-D product ``A @ W`` here.  A library product picks its
algorithm by the shape, so one row of ``A @ W`` can come out differently when
the same row sits in a product of another row count: on an H100 cuBLAS picks
another kernel above 16 rows, and on the CPU a single row takes a
matrix-vector path.  The engine's bitwise invariants compare runs that put
the same row into products of different sizes (a fused window ≡ the serial
loop, device ≡ offload, sharded ≡ device, hybrid ≡ offload), so each row of
this product is a function of that row and ``W`` alone, by construction:

* on a card, the kernel ``csrc/row_linear.cu`` sums each element in one
  ``fmaf`` chain over k = 0 … K−1, whatever M or the tiling;
* on the CPU, :func:`row_linear_plain` runs the same k order as K
  elementwise steps ``out += A[:, k] ⊗ W[k]`` (a multiply, then an add: no
  contraction, and an elementwise op computes every element alike).

The two differ by the fused multiply-add's rounding (≤ 1e-5 at the engine's
widths), each is independent of M bitwise.  The JAX package has no kernel
here: its products are left to XLA, and its invariants are its own.
:func:`row_linear` dispatches on the device of ``a``: CPU tensors go to the
plain version, CUDA tensors to the kernel, anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I64, PTR, CudaKernel

KERNEL = CudaKernel("row_linear", {"row_linear_f32": (PTR, PTR, PTR, I64, I64, I64, PTR)})


def row_linear_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: K multiply-then-add steps in ascending k."""
    _check_shapes(a, w)
    m, k = a.shape
    out = a.new_zeros((m, w.shape[1]))
    for kk in range(k):
        out += a[:, kk:kk + 1] * w[kk]
    return out


def row_linear(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M, K] @ [K, N]`` float32 with rows independent of M (see module doc)."""
    dev = a.device
    if dev.type == "cpu":
        if w.device != dev:
            raise ValueError(f"a is on {dev}, w on {w.device}")
        return row_linear_plain(a, w)
    if dev.type != "cuda":
        raise ValueError(f"row_linear: unsupported device {dev}")
    _check_shapes(a, w)
    if w.device != dev:
        raise ValueError(f"a is on {dev}, w on {w.device}")
    if a.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"row_linear takes float32, got {a.dtype} and {w.dtype}")
    a, w = a.contiguous(), w.contiguous()
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch("row_linear_f32", a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                      stream)
    return out


def _check_shapes(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"row_linear takes [M, K] @ [K, N], got {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
