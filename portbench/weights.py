"""Weights and images made from the seed, on the device.

Both sides get the same tensors: the program as ``serve(params=...)``,
the reference after the window, made again from the seed.  Weights come
from one ``randn`` over every weight and bias on a device generator,
scaled in place by each element's standard deviation (He for convs,
``1/sqrt(fan_in)`` for fcs, ``bias_std`` for biases, and the
configuration's ``branch_scale`` on the layers it names) and cut into
views.  Images are standard normal, as normalised pixels are, made on the
device (the mix's ``ingress`` says whether they then move to host
memory).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Mapping, Sequence

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed`` (any int)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _std(layer, spec: Mapping) -> float:
    if layer.kind == "fc":
        std = math.sqrt(1.0 / layer.cin)
    else:
        std = math.sqrt(2.0 / layer.fan_in)
    scale = spec.get("branch_scale")
    if scale and layer.name.endswith(tuple(scale["suffixes"])):
        std *= scale["factor"]
    return std


def make_weights(layers: Sequence, seed: int, spec: Mapping, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {"w": HWIO or [in, out], "b": [out]}}``, f32 on ``device``."""
    shapes, stds = [], []
    for layer in layers:
        shapes += [layer.w_shape, (layer.cout,)]
        stds += [_std(layer, spec), float(spec["bias_std"])]
    sizes = [math.prod(s) for s in shapes]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    flat.mul_(torch.repeat_interleave(
        torch.tensor(stds, device=device), torch.tensor(sizes, device=device),
        output_size=total,
    ))
    parts = iter(flat.split(sizes))
    return {
        layer.name: {"w": next(parts).view(layer.w_shape), "b": next(parts)}
        for layer in layers
    }


def make_images(n: int, shape: Sequence[int], seed: int, device) -> torch.Tensor:
    """``n`` images of ``shape`` (H, W, C), made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "images"))
    return torch.randn((n, *shape), generator=gen, device=device)
