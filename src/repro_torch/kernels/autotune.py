"""Descriptor cache keys for per-layer measured times.

Only ``descriptor_key`` is ported so far: the performance model
(core/perfmodel.py) looks measured layer times up by it, so its keys must
stay byte-identical to the JAX package's.  The block-size autotuner
(``ConvAutotuner``) is a later slice.
"""
from __future__ import annotations

from ..core.descriptors import ConvDescriptor


def descriptor_key(desc: ConvDescriptor, op: str = "conv_fused") -> str:
    """Geometry-only cache key (layer-name independent)."""
    if desc.kind == "fc":
        return f"{op}/f32/fc/K{desc.i_w * desc.i_h * desc.i_d}/M{desc.ofm}"
    return (
        f"{op}/f32/i{desc.i_h}x{desc.i_w}x{desc.i_d}/f{desc.f_h}x{desc.f_w}"
        f"/s{desc.stride}/p{desc.pad}/g{desc.groups}/ofm{desc.ofm}"
    )
