"""The optimizer of the port: :mod:`.adamw`."""

from .adamw import AdamWConfig, OptState, apply_updates, cosine_lr, init_opt_state

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "apply_updates", "cosine_lr"]
