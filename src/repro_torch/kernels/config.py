"""Device resolution for the port's entry points.

The route a kernel wrapper takes is decided by the device of the tensor
it is handed, and by nothing else: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor launches the hand-written kernel (or raises).
Entry points take an explicit ``device``; ``None`` means the card, and a
host without one raises instead of quietly serving on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device on a host without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available on this "
            "host; pass device='cpu' to run the plain PyTorch route"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for every queued kernel on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
