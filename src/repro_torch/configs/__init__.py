"""Architecture config registry: ``get_config(arch_id)``."""
from .registry import ARCHS, get_config
from .shapes import SHAPES, InputShape

__all__ = ["ARCHS", "get_config", "SHAPES", "InputShape"]
