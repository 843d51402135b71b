"""Where the port's entry points run.

Entry points take ``device=None`` to mean the card.  Without a CUDA device
that is an error, never a quiet move to the CPU: a caller who wants the plain
CPU path (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: kubernetes_tpu_torch runs on the card by "
                "default; pass device='cpu' to run the plain CPU path"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def h2d(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    """A small host array as a new tensor on `device`: on the card an
    explicit copy from pinned memory, queued on the current stream with no
    host synchronisation (a copy from pageable memory would wait for the
    stream); on the CPU a copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cpu":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)
