"""The assigned input shapes (port of ``repro/configs/shapes.py``): one
set per LM arch, 4 shapes, 40 cells.

  train_4k     seq 4,096   global_batch 256   the train step
  prefill_32k  seq 32,768  global_batch 32    the prefill step
  decode_32k   seq 32,768  global_batch 128   the serve step (1 new token,
                                              a KV / state cache of seq_len)
  long_500k    seq 524,288 global_batch 1     the serve step; needs a
                                              sub-quadratic arch (SWA / SSM /
                                              hybrid / linear attention)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models.lm import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "input_specs", "cell_applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str           # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token decode needs a "
                       "sub-quadratic mechanism (SWA/SSM/linear); skipped "
                       "per DESIGN.md §4")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                device="meta") -> Dict[str, torch.Tensor]:
    """Uninitialised stand-ins for the data inputs of one step, with the
    reference's shapes and dtypes: on ``meta`` they hold no memory, and
    under a ``FakeTensorMode`` on any device they are fake."""
    b, s = shape.global_batch, shape.seq_len

    def empty(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.step == "decode":
        return {"tokens": empty((b, 1))}
    if cfg.frontend == "audio_stub":      # EnCodec frame embeddings
        batch = {"embeds": empty((b, s, cfg.d_model), cfg.torch_dtype)}
        if shape.step == "train":
            batch["labels"] = empty((b, s))
        return batch
    if cfg.frontend == "vision_stub":
        nv = cfg.vision_tokens
        batch = {"tokens": empty((b, s - nv)),
                 "vision_embeds": empty((b, nv, cfg.d_model),
                                        cfg.torch_dtype)}
        if shape.step == "train":
            batch["labels"] = empty((b, s - nv))
        return batch
    batch = {"tokens": empty((b, s))}
    if shape.step == "train":
        batch["labels"] = empty((b, s))
    return batch
