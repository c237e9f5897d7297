"""Processor-Accelerator Training Protocol (paper Section III-C, Listing 1).

Port of ``repro/core/protocol.py``:

* ``Synchronizer`` — the condition-variable DONE handshake of Listing 1:
  each trainer stages its gradients and increments DONE; when DONE equals
  the number of trainers the gradients are averaged, weighted by
  mini-batch share (sync SGD over unequal shares).
* ``TrainerHandle`` — one logical GNN trainer: runs the loss and autograd
  on its own device, then waits for that device (the port's
  ``block_until_ready``) so ``t_train`` measures the work, not its enqueue.
* ``Runtime`` — collects per-stage times each iteration and feeds the DRM
  engine (Section IV-A, Fig. 5).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..annotations import guarded_by
from ..device import synchronize
from .drm import Assignment, DRMEngine, StageTimes

__all__ = ["Synchronizer", "TrainerHandle", "Runtime"]

Grads = Dict[str, torch.Tensor]


@guarded_by("_cond", "_done", "_slots")
class Synchronizer:
    """Listing-1 handshake: pthread cond/mutex -> threading.Condition.

    Gradients are moved to ``device`` (where the authoritative parameters
    live) before the weighted average."""

    def __init__(self, n_trainers: int, device: torch.device) -> None:
        self.n_trainers = n_trainers
        self.device = device
        self._cond = threading.Condition()
        self._done = 0
        self._slots: List[Optional[Tuple[Grads, float]]] = [None] * n_trainers

    def submit(self, trainer_idx: int, grads: Grads, weight: float) -> None:
        """Trainer side: stage gradients, increment DONE, signal."""
        with self._cond:
            self._slots[trainer_idx] = (grads, weight)
            self._done += 1
            self._cond.notify_all()

    def all_reduce(self) -> Grads:
        """Synchronizer side: wait until DONE == n, then take the average
        weighted by mini-batch share, so hybrid training with unequal shares
        is single-device large-batch SGD (paper Section II-B)."""
        with self._cond:
            while self._done != self.n_trainers:       # Listing 1 line 24
                self._cond.wait()
            slots = list(self._slots)                  # gather_data()
            self._done = 0
            self._slots = [None] * self.n_trainers
        total_w = sum(w for _, w in slots)
        avg: Grads = {}
        for grads, w in slots:                         # average_gradients()
            for k, g in grads.items():
                s = g.to(self.device) * (w / total_w)
                avg[k] = s if k not in avg else avg[k] + s
        return avg


@dataclasses.dataclass
class TrainerHandle:
    """One logical GNN Trainer (paper Section III-A)."""
    name: str
    kind: str                    # "cpu" | "accel"
    device: torch.device
    grad_fn: Callable[..., Tuple[Grads, Dict[str, Any]]]
    index: int

    def run(self, sync: Synchronizer, params: Dict[str, torch.Tensor],
            weight: float, *args: Any) -> Dict[str, Any]:
        t0 = time.perf_counter()
        grads, metrics = self.grad_fn(params, *args)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        sync.submit(self.index, grads, weight)          # DONE++, signal
        metrics = dict(metrics)
        metrics["t_train"] = dt
        return metrics


class Runtime:
    """Collects stage times, runs the DRM engine between iterations."""

    def __init__(self, assignment: Assignment, use_drm: bool = True,
                 damping: float = 0.25, share_quantum: int = 64) -> None:
        self.drm = DRMEngine(assignment, damping=damping)
        self.use_drm = use_drm
        self.share_quantum = max(1, int(share_quantum))
        self.history: List[StageTimes] = []

    @property
    def assignment(self) -> Assignment:
        return self.drm.assign

    def quantized_shares(self) -> Tuple[int, int]:
        """(cpu_batch, accel_batch_each), the accelerator share rounded down
        to the share quantum and the remainder folded into the CPU share.
        The reference rounds to bound XLA recompiles; the port keeps the
        rounding so both take the same DRM decisions."""
        a = self.drm.assign
        q = self.share_quantum
        accel = (a.accel_batch // q) * q
        cpu = a.total_batch - accel * a.n_accel
        return cpu, accel

    def end_iteration(self, times: StageTimes) -> Assignment:
        self.history.append(times)
        if self.use_drm:
            return self.drm.step(times)
        return self.drm.assign

    def mean_iteration_time(self, skip: int = 1) -> float:
        xs = [t.iteration_time() for t in self.history[skip:]] or [0.0]
        return float(np.mean(xs))
