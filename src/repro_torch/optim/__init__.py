from .adamw import AdamWState, adamw_init, adamw_update, cosine_schedule, clip_by_global_norm

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "clip_by_global_norm",
]
