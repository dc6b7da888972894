from .checkpoint import load_checkpoint, restore, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "restore"]
