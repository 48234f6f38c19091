from .adamw import AdamWState, adamw_init, adamw_update, cosine_lr

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr"]
