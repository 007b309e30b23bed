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

* on a card, the kernels of ``csrc/row_linear.cu`` sum each element in one
  ``fmaf`` chain over k = 0 … K−1, whatever M or the tiling: the general
  kernel for any shape, and a persistent kernel that holds W in shared
  memory for the engine's shapes (N = 128, K a multiple of 16 up to 256).
  The chain fixes every bit, so the two give the same bits and
  :func:`kernel_entry` may pick either;
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

from repro_torch.kernels import _fake
from repro_torch.kernels._build import I64, PTR, CudaKernel

TILED_N = 128  # the tiled kernel's N: one 128-wide output tile, every row of A read once
TILED_K_STEP, TILED_K_MAX = 16, 256  # its K: W (K·N·4 bytes ≤ 128 KB) sits in shared memory
#: one 128-row tile for each of an H100's 132 SMs: below it the tiled kernel leaves SMs
#: idle, and the general kernel's 64 × 64 tiles spread over more of them
TILED_MIN_ROWS = 128 * 132
ENTRIES = ("row_linear_f32", "row_linear_f32_tiled")  # the general and the tiled kernel
_ARGS = (PTR, PTR, PTR, I64, I64, I64, PTR)  # a, w, out, m, k, n, stream
KERNEL = CudaKernel("row_linear", {name: _ARGS for name in ENTRIES})


def kernel_entry(m: int, k: int, n: int, aligned: bool = True) -> str:
    """The C entry point :func:`row_linear` launches for ``[m, k] @ [k, n]``.

    ``row_linear_f32_tiled`` where it applies: N = 128, K a multiple of 16 up
    to 256, M at least ``TILED_MIN_ROWS``, and A, W and out 16-byte aligned
    (``aligned``: the tiled kernel moves 16 bytes a load and a store);
    ``row_linear_f32`` otherwise.  Both sum each element in the same chain,
    so the choice moves time, never bits."""
    tiled = (n == TILED_N and k % TILED_K_STEP == 0 and 0 < k <= TILED_K_MAX
             and m >= TILED_MIN_ROWS and aligned)
    return ENTRIES[1] if tiled else ENTRIES[0]


def row_linear_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: K multiply-then-add steps in ascending k."""
    _check_shapes(a, w)
    m, k = a.shape
    out = a.new_zeros((m, w.shape[1]))
    for kk in range(k):
        out += a[:, kk:kk + 1] * w[kk]
    return out


def row_linear(a: torch.Tensor, w: torch.Tensor, *, entry: str | None = None) -> torch.Tensor:
    """``[M, K] @ [K, N]`` float32 with rows independent of M (see module doc).

    ``entry`` names the C entry point to launch on a card instead of
    :func:`kernel_entry`'s choice, so that the two kernels can be held
    against each other on the same inputs (the CPU runs the plain version
    whatever it names); a shape the tiled kernel does not take makes its
    launch raise."""
    if entry is not None and entry not in ENTRIES:
        raise ValueError(f"row_linear: entry must be one of {ENTRIES}, got {entry!r}")
    if isinstance(a, _fake.FakeTensor):
        _check_shapes(a, w)
        a, w = a.contiguous(), w.contiguous()
        out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
        _fake.report("row_linear", 2.0 * a.shape[0] * a.shape[1] * w.shape[1],
                     _fake.nbytes(a, w, out))
        return out
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
    aligned = (a.data_ptr() | w.data_ptr() | out.data_ptr()) % 16 == 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(entry or kernel_entry(m, k, n, aligned), a.data_ptr(), w.data_ptr(),
                      out.data_ptr(), m, k, n, stream)
    return out


def _check_shapes(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"row_linear takes [M, K] @ [K, N], got {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
