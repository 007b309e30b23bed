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
inputs in one bf16 product, both with fp32 accumulation.  bf16 at dh 64, 128
and 160 (the production dtype's path) runs kernels fed by TMA tensor copies
(``csrc/tma.cuh``): the forward warp-specialised (persistent at dh 64 and
128), the backward warp-specialised at dh 128 and 160, and at dh 64 a dQ
kernel of one warpgroup a block beside the older dK/dV kernel.  Kernel source and
its note on what bounds it:
``repro_torch/csrc/flash_attention.cu``.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

:func:`flash_attention` dispatches on the device of q: CPU tensors go to the
plain version, CUDA tensors to the kernel (fp32 or bf16, contiguous,
16-byte aligned, dh in :data:`HEAD_DIMS`: 16, 32, 64, 128 and 160), anything
else raises.  It never falls back from the card to the plain version.

Training.  When grad is enabled and an input requires it,
:func:`flash_attention` goes through :class:`_FlashAttention`: its forward
is :func:`flash_attention_lse` (the same kernel, which also writes the row
log-sum-exp ``lse = ln Σ_j exp(q·k_j · scale)`` over the visible keys, fp32
``[B, Hq, Sq]``, ``-inf`` for a row that sees no key) and its backward
:func:`flash_attention_bwd`, two hand-written kernels of
``repro_torch/csrc/flash_attention_bwd.cu``: the dQ kernel (which also
writes D = rowsum(dO ∘ O)) and then the dK/dV kernel, each output element
with one owner (no atomics), their products on the tensor cores as the
forward's (split TF32 for fp32, bf16 for bf16), at dh in
:data:`BWD_HEAD_DIMS` (the forward's: 16, 32, 64, 128 and 160).  Their plain
versions are :func:`repro_torch.kernels.ref.flash_attention_lse_ref` and
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.  Without grad the
path is the serving one: the same launch, no ``lse``, the same bits.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _fake
from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import F32, I32, I64, PTR, CudaKernel
from repro_torch.kernels.segment_spmm import _same_device

#: int fn(q, k, v, o, lse (nullable), b, hq, hkv, sq, sk, dh, float scale,
#:        int causal, long long window (≤ 0: none), long long q_offset, stream)
ARGTYPES = (PTR, PTR, PTR, PTR, PTR, I64, I64, I64, I64, I64, I64, F32, I32, I64, I64, PTR)
KERNEL = CudaKernel("flash_attention", {"flash_attention_f32": ARGTYPES,
                                        "flash_attention_bf16": ARGTYPES})
#: dQ entry: int fn(q, k, v, o, lse, do, dq, delta, b, hq, hkv, sq, sk, dh,
#:                  float scale, int causal, long long window, long long q_offset, stream)
#: dK/dV entry: int fn(q, k, v, lse, do, delta, dk, dv, <the same sizes and masks>, stream)
BWD_ARGTYPES = (PTR,) * 8 + (I64,) * 6 + (F32, I32, I64, I64, PTR)
BWD_ENTRIES = ("dq", "dkdv")
BWD_KERNEL = CudaKernel("flash_attention_bwd", {
    f"flash_attention_bwd_{entry}_{t}": BWD_ARGTYPES
    for entry in BWD_ENTRIES for t in ("f32", "bf16")})
HEAD_DIMS = (16, 32, 64, 128, 160)  # the forward kernel's
BWD_HEAD_DIMS = HEAD_DIMS  # the backward kernels'
_SYMBOLS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_BWD_TYPE = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: the fewest query rows (dQ) or keys (dK/dV) a block of the backward kernels owns
#: (64; 128 in fp32 up to dh 64, in the bf16 dQ kernels at dh 128 and 160 and in
#: the bf16 dK/dV kernel where it owns both sums): the grid's second dimension holds
#: S / 64 ≤ 65535
_BWD_TILE = 64


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """GQA attention of ``q`` over ``k``/``v`` (see module doc); differentiable
    through the backward kernels when an input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: :func:`flash_attention`'s output and the row
    log-sum-exp of the scaled scores over the visible keys (fp32 ``[B, Hq,
    Sq]``, ``-inf`` where a row sees no key), from one launch."""
    return _forward(q, k, v, causal, window, q_offset, with_lse=True)


def _forward(q, k, v, causal, window, q_offset, with_lse: bool):
    _check_shapes(q, k, v, window)
    if isinstance(q, _fake.FakeTensor):
        return _fake_forward(q, k, v, causal, window, q_offset, with_lse)
    dev = q.device
    if dev.type == "cpu":
        _same_device(dev, k, v)
        if with_lse:
            return kref.flash_attention_lse_ref(q, k, v, causal, window, q_offset)
        return kref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset), None
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    _check_cuda(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) if with_lse else None
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(_SYMBOLS[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None if lse is None else lse.data_ptr(),
                      b, hq, hkv, sq, sk, dh, 1.0 / math.sqrt(dh), int(bool(causal)),
                      0 if window is None else int(window), int(q_offset), stream)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` from its inputs, its output
    ``o``, its ``lse`` (:func:`flash_attention_lse`) and the output's
    gradient ``do``, in the dtypes of q, k, v.  CPU tensors go to
    :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`, CUDA tensors to
    the two backward kernels (the dQ kernel, then the dK/dV kernel, on the
    current stream), anything else raises."""
    _check_shapes(q, k, v, window)
    if q.device.type == "cuda" and q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {q.shape[3]} not in {BWD_HEAD_DIMS}")
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"o and do must be shaped like q {tuple(q.shape)} and lse "
                         f"{tuple(q.shape[:3])}, got {tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}")
    if isinstance(q, _fake.FakeTensor):
        return _fake_bwd(q, k, v, o, lse, do, causal, window, q_offset)
    dev = q.device
    if dev.type == "cpu":
        _same_device(dev, k, v, o, lse, do)
        return kref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {dev}")
    _check_cuda(q, k, v)
    _same_device(dev, o, lse, do)
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"o and do must have q's dtype {q.dtype} and lse float32, got "
                         f"{o.dtype}, {do.dtype}, {lse.dtype}")
    if not (o.is_contiguous() and do.is_contiguous() and lse.is_contiguous()):
        raise ValueError("o, lse and do must be contiguous")
    if any(t.data_ptr() % 16 for t in (o, do)):
        raise ValueError("o and do must start on 16-byte boundaries")
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if -(-sk // _BWD_TILE) > 65535 or -(-sq // _BWD_TILE) > 65535:
        raise ValueError(f"Sq = {sq} or Sk = {sk} exceeds {65535 * _BWD_TILE}")
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)  # rowsum(dO ∘ O)
    sizes = (b, hq, hkv, sq, sk, dh, 1.0 / math.sqrt(dh), int(bool(causal)),
             0 if window is None else int(window), int(q_offset))
    t = _BWD_TYPE[q.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        BWD_KERNEL.launch(f"flash_attention_bwd_dq_{t}", q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                          dq.data_ptr(), delta.data_ptr(), *sizes, stream)
        BWD_KERNEL.launch(f"flash_attention_bwd_dkdv_{t}", q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), *sizes, stream)
    return dq, dk, dv


def _pairs(q, k, causal, window, q_offset) -> int:
    """Visible (query, key) pairs of the call, over every batch row and head."""
    b, hq, sq, _ = q.shape
    return b * hq * _fake.visible_pairs(sq, k.shape[2], causal, window, q_offset)


def _fake_forward(q, k, v, causal, window, q_offset, with_lse: bool):
    """The CUDA route's allocations, no launch (:mod:`repro_torch.kernels._fake`):
    4 · dh FLOPs a visible pair (q·k and p·v)."""
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if with_lse else None
    _fake.report("flash_attention", 4.0 * q.shape[3] * _pairs(q, k, causal, window, q_offset),
                 _fake.nbytes(q, k, v, out, lse))
    return out, lse


def _fake_bwd(q, k, v, o, lse, do, causal, window, q_offset):
    """The backward's allocations (dq, dk, dv and the D scratch), no launch:
    10 · dh FLOPs a visible pair (S, dP, dV, dQ, dK)."""
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)  # noqa: F841
    _fake.report("flash_attention_bwd",
                 10.0 * q.shape[3] * _pairs(q, k, causal, window, q_offset),
                 _fake.nbytes(q, k, v, o, lse, do, dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with the hand-written backward: the forward saves q, k, v,
    o and lse; the backward recomputes P tile by tile from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_attention_lse(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), *ctx.masks)
        return dq, dk, dv, None, None, None


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
