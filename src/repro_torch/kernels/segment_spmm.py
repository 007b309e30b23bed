"""``segment_spmm``: deterministic destination segment sum (CUDA, ``sm_90a``).

    out[r] = Σ_{k=row_ptr[r]}^{row_ptr[r+1]-1} messages[order[k]]

``order`` may be ``None`` (the identity: records already sorted by row, as
the edges of ``CSRGraph.edges_by_dst`` are, with ``in_indptr`` as
``row_ptr``).  A row without records is exactly 0.

The port's counterpart of the Pallas TPU kernel
``repro.kernels.segment_spmm.segment_spmm``.  The TPU kernel needs a
block-aligned CSR layout (``prepare_block_csr``) shaped for its matrix unit;
the CUDA kernel takes a plain row schedule instead, which
:func:`prepare_row_schedule` builds on the host.  Kernel source and its note
on what bounds it: ``repro_torch/csrc/segment_spmm.cu``.

The kernel's order of additions (``csrc/row_sum.cuh``): a row of at most
``ROW_SUM_CHUNK`` records is one chain in record order, as
:func:`segment_spmm_plain` sums it; a longer row is summed in chunks of
``ROW_SUM_CHUNK`` records aligned to its first record, and the chunk sums are
added in chunk order.  :func:`row_sum_chunked_plain` is that order in
PyTorch, bit for bit; the tests and ``chip_smoke.py`` hold the kernel to it.

:func:`segment_spmm` dispatches on the device of its inputs: CPU tensors go
to :func:`segment_spmm_plain`, CUDA tensors to the kernel, anything else
raises.  It never falls back from the card to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _fake
from repro_torch.kernels._build import ROW_SUM_ARGTYPES, CudaKernel

KERNEL = CudaKernel("segment_spmm", {"segment_spmm_i32": ROW_SUM_ARGTYPES,
                                    "segment_spmm_i64": ROW_SUM_ARGTYPES})

#: records a chain sums at most: ``kChunk`` of ``csrc/row_sum.cuh`` (the TPU
#: kernel's edge block, BE = 512); not a knob
ROW_SUM_CHUNK = 512


def prepare_row_schedule(keys: np.ndarray, num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side row schedule for records with row ids ``keys``.

    Keys outside ``[0, num_rows)`` (e.g. ``-1`` padding) are dropped.
    Returns ``(order [len(keys)] int32, row_ptr [num_rows+1] int32)``:
    ``order`` is a stable argsort of the keys (dropped records last, never
    read), so each row's records keep their original relative order."""
    keys = np.asarray(keys, np.int64)
    live = (keys >= 0) & (keys < num_rows)
    k = np.where(live, keys, num_rows)
    order = np.argsort(k, kind="stable").astype(np.int32)
    counts = np.bincount(k, minlength=num_rows + 1)[:num_rows]
    row_ptr = np.zeros(num_rows + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return order, row_ptr


def segment_spmm_plain(
    messages: torch.Tensor,
    row_ptr: torch.Tensor,
    order: Optional[torch.Tensor] = None,
    num_rows: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path, and the kernel's
    comparison on the card).  ``index_add_`` on the CPU adds the records in
    k order, the kernel's order."""
    _check_rows(row_ptr, num_rows)
    r = row_ptr.shape[0] - 1
    lo, hi = int(row_ptr[0]), int(row_ptr[-1])
    e = torch.arange(lo, hi, device=row_ptr.device)
    if order is not None:
        e = order[lo:hi].long()
    rows = torch.repeat_interleave(torch.arange(r, device=row_ptr.device),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    out = messages.new_zeros((r, messages.shape[1]))
    out.index_add_(0, rows, messages[e])
    return out


def row_sum_chunked_plain(
    messages: torch.Tensor,
    row_ptr: torch.Tensor,
    order: Optional[torch.Tensor] = None,
    chunk: int = ROW_SUM_CHUNK,
) -> torch.Tensor:
    """The kernel's sums, bit for bit, in plain PyTorch (tests and
    ``chip_smoke.py`` only; no main path calls it).

    Row r's records ``[lo, hi)`` are cut into chunks ``[lo + j·chunk,
    min(lo + (j+1)·chunk, hi))``; each chunk is a chain in record order from
    0 (p_j), and the row is ``((p_0 + p_1) + p_2) + …``; a row without records
    is 0.  The loop over record positions ``j < chunk`` adds the j-th record
    of every chunk that has one at once, then the loop over chunk positions
    adds each row's next chunk sum."""
    _check_rows(row_ptr, None)
    dev = messages.device
    rp = row_ptr.long()
    lo, hi = rp[:-1], rp[1:]
    nchunks = (hi - lo + chunk - 1) // chunk
    first = torch.cumsum(nchunks, 0) - nchunks  # each row's first chunk
    crow = torch.repeat_interleave(torch.arange(len(lo), device=dev), nchunks)
    cstart = lo[crow] + (torch.arange(len(crow), device=dev) - first[crow]) * chunk
    clen = torch.clamp(hi[crow] - cstart, max=chunk)
    part = messages.new_zeros((len(crow), messages.shape[1]))
    for j in range(int(clen.max()) if len(crow) else 0):
        live = torch.nonzero(clen > j).squeeze(1)
        k = cstart[live] + j
        part[live] = part[live] + messages[order[k].long() if order is not None else k]
    out = messages.new_zeros((len(lo), messages.shape[1]))
    for c in range(int(nchunks.max()) if len(lo) else 0):
        rows = torch.nonzero(nchunks > c).squeeze(1)
        p = part[first[rows] + c]
        out[rows] = p if c == 0 else out[rows] + p
    return out


def _row_sum_scratch(num_records: int, d: int, device) -> Optional[torch.Tensor]:
    """The kernels' scratch for ``num_records`` records of width ``d``, or
    None when no row can be longer than ``ROW_SUM_CHUNK``: ``2·windows``
    chunk-sum slots of ``d`` floats, then ``windows`` int64 hub-row ids, with
    ``windows = ⌈num_records / ROW_SUM_CHUNK⌉`` (``row_sum_windows`` in
    ``csrc/row_sum.cuh``).  Sized from what the host knows, so no launch
    waits on the card."""
    if num_records <= ROW_SUM_CHUNK:
        return None
    windows = -(-num_records // ROW_SUM_CHUNK)
    return torch.empty(2 * windows * d + 2 * windows, dtype=torch.float32, device=device)


def _launch_row_sum(kernel: CudaKernel, prefix: str, messages: torch.Tensor,
                   row_ptr: torch.Tensor, order: Optional[torch.Tensor],
                   out: torch.Tensor) -> None:
    """Launch ``<prefix>_i32`` or ``<prefix>_i64`` of a row-sum library on the
    current stream, with its scratch, into ``out`` ``[R, D]``.  The records
    are ``order``'s entries, or the messages themselves without one; the
    schedule must not reach past them (``row_ptr[-1] - row_ptr[0]`` at most
    their count).  The scratch is released on return while the launch may
    still run: PyTorch's caching allocator hands its block out again only to
    work queued after it on the same stream."""
    r, d = out.shape
    num_records = order.shape[0] if order is not None else messages.shape[0]
    scratch = _row_sum_scratch(num_records, d, out.device)
    sym = f"{prefix}_i32" if row_ptr.dtype == torch.int32 else f"{prefix}_i64"
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        kernel.launch(sym, messages.data_ptr(), row_ptr.data_ptr(),
                      None if order is None else order.data_ptr(), out.data_ptr(),
                      r, d, num_records, None if scratch is None else scratch.data_ptr(),
                      stream)


def _fake_row_sum(name: str, messages, row_ptr, order, out, reads_out: bool) -> None:
    """A row-sum kernel's fake route: its scratch, no launch; one add a
    scheduled record element (every record counted live); each record and the
    schedule read once, ``out`` written once (and read first when
    ``reads_out``: ``delta_agg`` adds into it)."""
    num_records = order.shape[0] if order is not None else messages.shape[0]
    d = out.shape[1]
    scratch = _row_sum_scratch(num_records, d, out.device)  # noqa: F841
    _fake.report(name, float(num_records * d),
                 num_records * d * messages.element_size() + _fake.nbytes(row_ptr, order)
                 + (2 if reads_out else 1) * _fake.nbytes(out))


def segment_spmm(
    messages: torch.Tensor,
    row_ptr: torch.Tensor,
    order: Optional[torch.Tensor] = None,
    num_rows: Optional[int] = None,
) -> torch.Tensor:
    """``[E, D]`` float32 messages → ``[num_rows, D]`` row sums (see module doc).
    Plain local tensors only: a DTensor raises (under a mesh the callers run
    this inside ``local_map``, on each rank's rows)."""
    _refuse_dtensor(messages, row_ptr, order)
    if isinstance(messages, _fake.FakeTensor):
        out = torch.empty((row_ptr.shape[0] - 1, messages.shape[1]), dtype=torch.float32,
                          device=messages.device)
        _fake_row_sum("segment_spmm", messages, row_ptr, order, out, reads_out=False)
        return out
    dev = messages.device
    if dev.type == "cpu":
        _same_device(dev, row_ptr, order)
        return segment_spmm_plain(messages, row_ptr, order, num_rows)
    if dev.type != "cuda":
        raise ValueError(f"segment_spmm: unsupported device {dev}")
    _check_cuda(messages, row_ptr, order, num_rows)
    r = row_ptr.shape[0] - 1
    out = torch.empty((r, messages.shape[1]), dtype=torch.float32, device=dev)
    if r == 0 or messages.shape[1] == 0:
        return out
    _launch_row_sum(KERNEL, "segment_spmm", messages, row_ptr, order, out)
    return out


# ---------------------------------------------------------------------- #
# argument checks shared with delta_agg
# ---------------------------------------------------------------------- #
def _check_rows(row_ptr: torch.Tensor, num_rows: Optional[int]) -> None:
    if row_ptr.dim() != 1 or row_ptr.shape[0] < 1:
        raise ValueError(f"row_ptr must be 1-D with num_rows+1 entries, got {tuple(row_ptr.shape)}")
    if num_rows is not None and row_ptr.shape[0] != num_rows + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, expected {num_rows + 1}")


def _refuse_dtensor(*tensors) -> None:
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError("segment_spmm takes plain local tensors, got a DTensor: call it inside "
                        "local_map (repro_torch.dist.ctx.local_apply) on each rank's rows")


def _same_device(dev: torch.device, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got one on {t.device}")


def _check_cuda(messages, row_ptr, order, num_rows) -> None:
    """Everything the kernel does not take raises here, before a launch."""
    _same_device(messages.device, row_ptr, order)
    if messages.dtype != torch.float32 or messages.dim() != 2 or not messages.is_contiguous():
        raise ValueError(
            f"messages must be contiguous 2-D float32, got {messages.dtype} "
            f"{tuple(messages.shape)} contiguous={messages.is_contiguous()}")
    _check_rows(row_ptr, num_rows)
    if row_ptr.dtype not in (torch.int32, torch.int64) or not row_ptr.is_contiguous():
        raise ValueError(f"row_ptr must be contiguous int32/int64, got {row_ptr.dtype}")
    if order is not None:
        if order.dim() != 1 or order.dtype != row_ptr.dtype or not order.is_contiguous():
            raise ValueError(
                f"order must be contiguous 1-D {row_ptr.dtype}, got {order.dtype} "
                f"{tuple(order.shape)}")
