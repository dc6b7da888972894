"""Carry parameters across from the JAX package.

``Graph.init`` in the two packages draws different random numbers from
the same seed, so parity runs take the reference's parameters, converted
to numpy by the caller, and turn them into the port's tensors here: the
layouts are the same (HWIO filters, [in, out] fc weights), so nothing is
transposed.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..kernels.config import resolve_device


def params_from_numpy(
    params_np: Mapping[str, Mapping[str, np.ndarray]], device=None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{node: {"w": array, "b": array}}`` -> float32 tensors on ``device``
    (``None`` means the card)."""
    dev = resolve_device(device)
    return {
        node: {
            k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in p.items()
        }
        for node, p in params_np.items()
    }
