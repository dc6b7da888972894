"""Device resolution for the port's entry points.

The route a kernel wrapper takes is decided by the device of the tensor
it is handed, and by nothing else: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor launches the hand-written kernel (or raises).
Entry points take an explicit ``device``; ``None`` means the card, and a
host without one raises instead of quietly serving on the CPU.

The port computes in IEEE f32 on every route (no TF32) until a labelled
TF32 route exists.  cuBLAS already does so by default; cuDNN's
convolutions do not (``torch.backends.cudnn.allow_tf32`` is True by
default), and the port calls ``F.conv2d`` for depthwise and grouped
convs and in the fused conv's plain version.  So the first time a CUDA
device is resolved, or such a conv runs on a CUDA tensor,
:func:`ieee_f32_convs` turns TF32 off for cuDNN, process-wide and once:
one assignment, never saved and restored around a call, so the stage
workers of a server, which run convs on several threads, cannot race on
it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_ieee_set = False


def ieee_f32_convs() -> None:
    """Make cuDNN's f32 convolutions IEEE f32 (TF32 off), once per
    process.  The legacy flag is the one set: it also reads back under
    the per-operator API (``torch.backends.cudnn.conv.fp32_precision``
    follows it), where setting that API alone would make a later read of
    ``torch.backends.cudnn.allow_tf32`` raise."""
    global _ieee_set
    if not _ieee_set:
        torch.backends.cudnn.allow_tf32 = False
        _ieee_set = True


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device on a host without CUDA raises.
    Resolving a CUDA device turns TF32 off for cuDNN (:func:`ieee_f32_convs`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available on this "
                "host; pass device='cpu' to run the plain PyTorch route"
            )
        ieee_f32_convs()
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for every queued kernel on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
