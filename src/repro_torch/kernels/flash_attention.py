"""``flash_attention``: streaming-softmax attention with GQA (CUDA, ``sm_90a``).

    o[b, h, i] = softmax over the keys row i may see of (q·k / √dh) · v

with the causal mask ``kpos ≤ qpos``, an optional window ``kpos > qpos −
window``, ``qpos = i + q_offset``, KV head ``h // (Hq / Hkv)`` and fp32
softmax state; a row that sees no key gives 0.  q ``[B, Hq, Sq, dh]``, k
and v ``[B, Hkv, Sk, dh]``, output in q's dtype.

The port's counterpart of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``.  The TPU kernel needs Sq
and Sk divisible by its tiles and KV heads repeated g times by its wrapper;
the CUDA kernel masks the ragged ends and reads KV head ``h // g`` in place.
It runs on the tensor cores (``wgmma``): fp32 inputs in error-compensated
split TF32 (three TF32 products per product, about fp32's accuracy), bf16
inputs in one bf16 product, both with fp32 accumulation.  Kernel source and
its note on what bounds it:
``repro_torch/csrc/flash_attention.cu``.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

:func:`flash_attention` dispatches on the device of q: CPU tensors go to the
plain version, CUDA tensors to the kernel (fp32 or bf16, contiguous,
16-byte aligned, dh in :data:`HEAD_DIMS`), anything else raises.  It never
falls back from the card to the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import F32, I32, I64, PTR, CudaKernel
from repro_torch.kernels.segment_spmm import _same_device

#: int fn(q, k, v, o, b, hq, hkv, sq, sk, dh, float scale, int causal,
#:        long long window (≤ 0: none), long long q_offset, stream)
ARGTYPES = (PTR, PTR, PTR, PTR, I64, I64, I64, I64, I64, I64, F32, I32, I64, I64, PTR)
KERNEL = CudaKernel("flash_attention", {"flash_attention_f32": ARGTYPES,
                                        "flash_attention_bf16": ARGTYPES})
HEAD_DIMS = (16, 32, 64, 128)
_SYMBOLS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_BQ = 128  # query rows per block; the grid's second dimension holds Sq / 128 ≤ 65535


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """GQA attention of ``q`` over ``k``/``v`` (see module doc)."""
    _check_shapes(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        _same_device(dev, k, v)
        return kref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check_cuda(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(_SYMBOLS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, sk, dh, 1.0 / math.sqrt(dh),
                      int(bool(causal)), 0 if window is None else int(window), int(q_offset),
                      stream)
    return out


def _check_shapes(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"expected q [B, Hq, Sq, dh] and k, v [B, Hkv, Sk, dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B and dh, Hkv dividing Hq)")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or ≥ 1, got {window}")


def _check_cuda(q, k, v) -> None:
    """Everything the kernel does not take raises here, before a launch."""
    _same_device(q.device, k, v)
    if q.dtype not in _SYMBOLS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of float32/bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 16-byte boundaries (the kernel's bulk copies)")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {HEAD_DIMS}")
    if -(-q.shape[2] // _BQ) > 65535:
        raise ValueError(f"Sq = {q.shape[2]} exceeds {65535 * _BQ}")
