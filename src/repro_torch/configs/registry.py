"""Config registry: loads ``<arch-id>.py`` files (ids contain dashes, so
they are loaded by path rather than imported as modules)."""
from __future__ import annotations

import importlib.util
import os
from typing import Dict, List

from ..models.config import ModelConfig

_DIR = os.path.dirname(__file__)

ARCHS: List[str] = [
    "xlstm-1.3b",
    "hymba-1.5b",
    "command-r-plus-104b",
    "deepseek-moe-16b",
    "paligemma-3b",
    "smollm-360m",
    "moonshot-v1-16b-a3b",
    "musicgen-large",
    "olmoe-1b-7b",
    "starcoder2-15b",
]

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch in _cache:
        return _cache[arch]
    path = os.path.join(_DIR, f"{arch}.py")
    if not os.path.exists(path):
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    spec = importlib.util.spec_from_file_location(f"repro_torch_config_{arch}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = mod.CONFIG
    _cache[arch] = cfg
    return cfg
