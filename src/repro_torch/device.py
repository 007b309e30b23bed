"""Where the port computes, and in what precision: shared by the GNN engine
(``repro_torch.serve.api``) and the LM (``repro_torch.models``); and how host
arrays reach the device (:func:`host_to_device`)."""
from __future__ import annotations

from typing import List, Sequence

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


def host_to_device(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Ship host arrays to ``device`` in one copy; returns one tensor per
    array, with its dtype and shape, as views of one device buffer.

    The arrays are laid end to end, each at an 8-byte boundary, in one fresh
    host byte buffer — pinned when ``device`` is a card, so the copy is
    ``non_blocking`` and the host can go on planning meanwhile.  A fresh
    buffer per call is never reused while its copy may be in flight:
    PyTorch's pinned-memory allocator holds a freed block until the copy's
    stream event has passed.  On the CPU the views alias the fresh host
    buffer (no copy of the caller's arrays is shared)."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 8) * 8
    cuda = device.type == "cuda"
    host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
    host_np = host.numpy()
    for a, off in zip(arrays, offsets):
        host_np[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True) if cuda else host
    return [buf[off:off + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1)).dtype).view(a.shape)
            for a, off in zip(arrays, offsets)]
