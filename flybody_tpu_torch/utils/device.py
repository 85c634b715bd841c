"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and no
    GPU is present — the port never falls back to the CPU silently."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch path")
    return dev
