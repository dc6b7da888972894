"""input_specs: ``meta`` tensors standing in for every model input, per
(architecture x input shape): shapes and dtypes, no storage, no device.

Port of ``repro/launch/specs.py``, whose ``jax.ShapeDtypeStruct``\\ s
become tensors on the ``meta`` device, which the port's steps run on
as they are (``launch/dryrun.py``).  Modality frontends are stubs, as in
the reference: PaliGemma gets 256 precomputed 1152-d SigLIP patch
embeddings; MusicGen gets 4 parallel EnCodec codebook token streams.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..configs.shapes import InputShape
from ..models import init_cache
from ..models.config import ModelConfig
from ..models.model import N_META_TOKENS, SIGLIP_DIM

META = torch.device("meta")


def _spec(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.n_codebooks:
        return {"tokens": _spec((b, s, cfg.n_codebooks)), "labels": _spec((b, s, cfg.n_codebooks))}
    if cfg.n_patches:
        # image patches are part of the sequence budget: text = s - patches
        st = s - cfg.n_patches
        return {
            "tokens": _spec((b, st)),
            "labels": _spec((b, st)),
            "patches": _spec((b, cfg.n_patches, SIGLIP_DIM), torch.float32),
        }
    if cfg.block_kind == "hymba":
        # meta tokens are prepended inside the model; keep total = s
        return {"tokens": _spec((b, s - N_META_TOKENS)), "labels": _spec((b, s - N_META_TOKENS))}
    return {"tokens": _spec((b, s)), "labels": _spec((b, s))}


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def cache_abstract(cfg: ModelConfig, shape: InputShape) -> List[Any]:
    return init_cache(cfg, shape.global_batch, max_len=shape.seq_len, device=META)


def decode_specs(cfg: ModelConfig, shape: InputShape):
    b = shape.global_batch
    tok = _spec((b, 1, cfg.n_codebooks) if cfg.n_codebooks else (b, 1))
    pos = _spec(())
    return cache_abstract(cfg, shape), tok, pos


def input_specs(cfg: ModelConfig, shape: InputShape):
    """The step's inputs for this shape: {"batch"} (train), {"batch",
    "caches"} (prefill) or {"caches", "tokens", "pos"} (decode)."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {
            "batch": prefill_batch_specs(cfg, shape),
            "caches": cache_abstract(cfg, shape),
        }
    caches, tok, pos = decode_specs(cfg, shape)
    return {"caches": caches, "tokens": tok, "pos": pos}
