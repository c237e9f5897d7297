from .compression import CompressionSpec, compress_grads, decompress_grads
from .optimizers import (Optimizer, adam, adamw, apply_updates,
                         clip_by_global_norm, cosine_warmup_schedule, sgd)

__all__ = ["Optimizer", "sgd", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "cosine_warmup_schedule",
           "CompressionSpec", "compress_grads", "decompress_grads"]
