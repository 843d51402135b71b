"""Where the port's entry points run.

Entry points take ``device=None`` to mean the card.  Without a CUDA device
that is an error, never a quiet move to the CPU: a caller who wants the plain
CPU path (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

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
