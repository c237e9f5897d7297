from .compression import CompressionSpec, compress_grads, decompress_grads
from .optimizers import Optimizer, adamw, apply_updates

__all__ = ["Optimizer", "adamw", "apply_updates", "CompressionSpec",
           "compress_grads", "decompress_grads"]
