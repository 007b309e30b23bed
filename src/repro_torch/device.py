"""Where the port computes, and in what precision: shared by the GNN engine
(``repro_torch.serve.api``) and the LM (``repro_torch.models``); and how host
arrays reach the device (:func:`host_to_device`)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names a card that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def set_fp32_precision() -> None:
    """Full float32 for matmuls and convolutions: TF32 off, process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


#: the shape and dtype of one array in a byte buffer
Spec = Tuple[Tuple[int, ...], np.dtype]


def byte_layout(specs: Sequence[Spec]) -> Tuple[List[int], int]:
    """Offsets of arrays of ``(shape, dtype)`` laid end to end in one byte
    buffer, each at an 8-byte boundary, and the buffer's length."""
    offsets, total = [], 0
    for shape, dtype in specs:
        offsets.append(total)
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        total += -(-nbytes // 8) * 8
    return offsets, total


def carve(buf, specs: Sequence[Spec], offsets: Sequence[int]) -> list:
    """Typed views into a byte buffer laid out by :func:`byte_layout`, one
    per spec: numpy views of a ``uint8`` array, or tensor views of a
    ``torch.uint8`` tensor."""
    out = []
    for (shape, dtype), off in zip(specs, offsets):
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        raw = buf[off:off + nbytes]
        if isinstance(buf, np.ndarray):
            out.append(raw.view(dtype).reshape(shape))
        else:
            out.append(raw.view(torch.from_numpy(np.empty(0, dtype)).dtype).view(shape))
    return out


def host_to_device(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Ship host arrays to ``device`` in one copy; returns one tensor per
    array, with its dtype and shape, as views of one device buffer.

    The arrays are laid end to end (:func:`byte_layout`) in one fresh host
    byte buffer — pinned when ``device`` is a card, so the copy is
    ``non_blocking`` and the host can go on planning meanwhile.  A fresh
    buffer per call is never reused while its copy may be in flight:
    PyTorch's pinned-memory allocator holds a freed block until the copy's
    stream event has passed.  On the CPU the views alias the fresh host
    buffer (no copy of the caller's arrays is shared)."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    specs = [(a.shape, a.dtype) for a in arrays]
    offsets, total = byte_layout(specs)
    cuda = device.type == "cuda"
    host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
    host_np = host.numpy()
    for a, off in zip(arrays, offsets):
        host_np[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True) if cuda else host
    return carve(buf, specs, offsets)
