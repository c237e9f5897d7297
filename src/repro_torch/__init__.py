"""PyTorch + CUDA port of the HyScale-GNN reproduction (``repro``).

The layout mirrors ``repro``: ``graph/`` (storage, sampler, hot cache,
loader, models), ``kernels/`` (the hand-written Hopper kernels, their plain
PyTorch versions and the dispatching wrappers), ``optim/``, ``core/``
(DRM, performance model, pipeline, protocol, the hybrid trainer), and the
LM stack: ``models/``, ``data/`` (the token pipeline) and ``launch/``.  The
package imports torch and numpy and nothing of ``repro`` or JAX; entry
points run on ``cuda:0`` unless the caller passes ``device="cpu"``.
"""
from .device import accel_devices, resolve_device

__all__ = ["resolve_device", "accel_devices"]
