from .optimizers import Optimizer, adamw, apply_updates

__all__ = ["Optimizer", "adamw", "apply_updates"]
