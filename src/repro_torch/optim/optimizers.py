"""SGD, Adam and AdamW on dicts of tensors, global-norm clipping and the
cosine warm-up schedule.

Port of ``repro/optim/optimizers.py``.  The API keeps the reference's
functional shape — ``opt = adamw(lr); state = opt.init(params); updates,
state = opt.update(grads, state, params); params = apply_updates(params,
updates)`` — so a training loop reads alike in both packages.  ``lr`` is a
float or a schedule ``step -> 0-d f32 tensor``; the step is a Python int.

Dtypes follow the reference's promotion rules, written out where torch's
differ from JAX's:

* the learning rate is an f32 value (not a weak Python scalar), so
  ``-lr_t * g`` is f32 whatever ``g``'s dtype, as in JAX;
* SGD's momentum buffer ``mu`` starts in the parameters' dtype and takes
  the dtype of ``momentum * mu + g``; the Python ``momentum`` is rounded to
  ``mu``'s dtype first, as JAX does with a weak scalar;
* AdamW's moments are f32 and live on the parameters' device (a DTensor
  parameter's moments are DTensors of its placements); the bias
  corrections are taken in f32 (``:69-87`` of the reference); the square
  root is the correctly rounded one on the host too (``_sqrt``).

The schedule computes in f32 torch ops.  XLA's f32 ``cos`` is not correctly
rounded and neither torch's nor numpy's reproduces it bit for bit, so the
schedule agrees with the reference's to one f32 ulp; the optimizers' own
arithmetic agrees bit for bit in f32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["Optimizer", "sgd", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "cosine_warmup_schedule"]

Tensors = Dict[str, torch.Tensor]
State = Dict[str, object]
Schedule = Callable[[int], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Tensors], State]
    update: Callable[[Tensors, State, Optional[Tensors]],
                     Tuple[Tensors, State]]


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def _to_schedule(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    value = torch.tensor(lr, dtype=torch.float32)
    return lambda step: value


def _lr(sched: Schedule, step: int) -> float:
    """The schedule's f32 value at ``step`` as a Python float (exact), so a
    product with a tensor of any device stays on that device."""
    return float(sched(step))


def _weak(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: how JAX casts a weak Python scalar
    before an operation on an array of that dtype."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's.  torch's vectorized
    f32 ``sqrt`` on the CPU is not (on an AVX512 host 173,415 of 10^6
    random inputs come out an ulp off), so a host tensor takes it in f64
    and rounds once (exact: f64 carries more than twice f32's bits); the
    card's f32 ``sqrt`` is correctly rounded and stays."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params: Tensors) -> State:
        mu = ({k: torch.zeros_like(p) for k, p in params.items()}
              if momentum else None)
        return {"step": 0, "mu": mu}

    def update(grads: Tensors, state: State,
               params: Optional[Tensors] = None) -> Tuple[Tensors, State]:
        step = int(state["step"]) + 1    # type: ignore[call-overload]
        neg_lr = -_lr(sched, step)
        if momentum:
            mu_prev: Tensors = state["mu"]   # type: ignore[assignment]
            mu = {k: mu_prev[k] * _weak(momentum, mu_prev[k].dtype) + g
                  for k, g in grads.items()}
            upd = {k: m.float() * neg_lr for k, m in mu.items()}
            return upd, {"step": step, "mu": mu}
        upd = {k: g.float() * neg_lr for k, g in grads.items()}
        return upd, {"step": step, "mu": None}

    return Optimizer(init, update)


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params: Tensors) -> State:
        return {
            "step": 0,
            "m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
        }

    def update(grads: Tensors, state: State,
               params: Optional[Tensors] = None) -> Tuple[Tensors, State]:
        step = int(state["step"]) + 1    # type: ignore[call-overload]
        lr_t = _lr(sched, step)
        # bias corrections in f32, as the reference computes them
        f32_step = torch.tensor(step, dtype=torch.float32)
        c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** f32_step)
        c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** f32_step)
        # lr_t * weight_decay in f32, as JAX multiplies an f32 array by a
        # weak scalar
        lr_wd = float(torch.tensor(lr_t, dtype=torch.float32)
                      * weight_decay)
        m_prev: Tensors = state["m"]   # type: ignore[assignment]
        v_prev: Tensors = state["v"]   # type: ignore[assignment]
        m, v, upd = {}, {}, {}
        for k, g in grads.items():
            g32 = g.float()
            m[k] = b1 * m_prev[k] + (1 - b1) * g32
            v[k] = b2 * v_prev[k] + (1 - b2) * g32 * g32
            u = -lr_t * (m[k] / c1) / (_sqrt(v[k] / c2) + eps)
            if weight_decay and params is not None:
                u = u - lr_wd * params[k].float()
            upd[k] = u
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """The gradients scaled by ``min(1, max_norm / (norm + 1e-12))``, each
    in its own dtype, and the f32 global norm (leaves summed in sorted key
    order, as JAX flattens a dict)."""
    total = torch.zeros((), dtype=torch.float32)
    for k in sorted(grads):
        g = grads[k]
        total = total.to(g.device) + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, gnorm


def cosine_warmup_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int,
                           min_ratio: float = 0.1) -> Schedule:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``; f32 arithmetic in
    the reference's operation order."""
    warm_div = float(max(1.0, warmup_steps))
    decay_div = float(max(1.0, total_steps - warmup_steps))
    half_span = (1 - min_ratio) * 0.5       # a Python double, as there

    def sched(step: int) -> torch.Tensor:
        s = torch.tensor(step, dtype=torch.float32)
        warm = s / warm_div
        prog = torch.clamp((s - warmup_steps) / decay_div, 0, 1)
        cos = min_ratio + half_span * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.minimum(warm, cos)

    return sched
