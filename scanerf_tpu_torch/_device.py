"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and there is
    no CUDA device. There is no silent move to the CPU: the caller asks
    for ``device="cpu"`` to run the plain PyTorch path."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
