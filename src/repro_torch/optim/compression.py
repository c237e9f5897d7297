"""Gradient compression for the synchronization path.

Port of ``repro/optim/compression.py`` over dicts of tensors: int8 with one
absmax scale per tensor, or bf16.  ``compress_grads`` then
``decompress_grads`` gives the values the reference gives, bit for bit:
the scale is ``max(max|x|, 1e-12) / 127`` in f32, the quantized value
``round(x / scale)`` (half to even, as ``jnp.round``) clipped to +-127, and
the bf16 cast rounds to nearest even.  Compression is lossy, so it is off
by default.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Tuple, Union

import torch

__all__ = ["CompressionSpec", "compress_grads", "decompress_grads"]

Tensors = Dict[str, torch.Tensor]
Compressed = Dict[str, Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    method: str = "none"          # "none" | "bf16" | "int8"
    METHODS: ClassVar[Tuple[str, ...]] = ("none", "bf16", "int8")

    @property
    def ratio(self) -> float:
        """Compression ratio vs fp32 (for the performance model)."""
        return {"none": 1.0, "bf16": 0.5, "int8": 0.25}[self.method]


def _q_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 0-d scale) of one tensor."""
    x32 = x.float()
    scale = x32.abs().max().clamp(min=1e-12) / 127.0
    q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: Tensors, spec: CompressionSpec) -> Compressed:
    if spec.method == "none":
        return dict(grads)
    if spec.method == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}
    if spec.method == "int8":
        return {k: _q_int8(g) for k, g in grads.items()}
    raise ValueError(spec.method)


def decompress_grads(comp: Compressed, spec: CompressionSpec,
                     like: Tensors) -> Tensors:
    """The gradients back in the dtypes of ``like`` (the parameters)."""
    if spec.method == "none":
        return dict(comp)
    if spec.method == "bf16":
        return {k: g.to(like[k].dtype) for k, g in comp.items()}
    if spec.method == "int8":
        return {k: (q.float() * scale).to(like[k].dtype)
                for k, (q, scale) in comp.items()}
    raise ValueError(spec.method)
