"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a card and without an explicit device this raises —
    the port never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def plain_or_cuda(t: torch.Tensor, name: str) -> bool:
    """True when a kernel wrapper must take its plain version (``t`` lies
    on the CPU), False when it must launch its kernel (``t`` lies on a CUDA
    device). Any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"{name}: unsupported device {t.device}")
