"""AdamW on dicts of tensors.

Port of ``repro/optim/optimizers.py:adamw``.  The API keeps the reference's
functional shape — ``opt = adamw(lr); state = opt.init(params); updates,
state = opt.update(grads, state, params); params = apply_updates(params,
updates)`` — so the trainer reads alike in both packages.  Moments are f32
and live on the parameters' device; the bias corrections are taken in f32
as the reference does (``:69-87``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["Optimizer", "adamw", "apply_updates"]

Tensors = Dict[str, torch.Tensor]
State = Dict[str, object]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], State]
    update: Callable[[Tensors, State, Optional[Tensors]],
                     Tuple[Tensors, State]]


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr32 = float(np.float32(lr))

    def init(params: Tensors) -> State:
        return {
            "step": 0,
            "m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
        }

    def update(grads: Tensors, state: State,
               params: Optional[Tensors] = None) -> Tuple[Tensors, State]:
        step = int(state["step"]) + 1
        # bias corrections in f32, as the reference computes them
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        m_prev: Tensors = state["m"]   # type: ignore[assignment]
        v_prev: Tensors = state["v"]   # type: ignore[assignment]
        m, v, upd = {}, {}, {}
        for k, g in grads.items():
            g32 = g.float()
            m[k] = b1 * m_prev[k] + (1 - b1) * g32
            v[k] = b2 * v_prev[k] + (1 - b2) * g32 * g32
            u = -lr32 * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
            if weight_decay and params is not None:
                u = u - lr32 * weight_decay * params[k].float()
            upd[k] = u
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
