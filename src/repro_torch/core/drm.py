"""Dynamic Resource Management (paper Section IV-A, Algorithm 1).

Port of ``repro/core/drm.py`` (the engine; the knob autotuner is not ported
yet — ``HybridConfig(auto_tune=True)`` raises).  A bottleneck-guided runtime
optimizer: from the measured per-stage times of the previous iteration it
derives the next iteration's workload assignment (mini-batch rows per
trainer) and thread assignment (threads per CPU stage).

* ``T_Accel = max(T_Tran, T_TA)`` (transfer and accelerator training are
  bundled: both scale with the accelerator's share),
* bottleneck = slowest of {T_SC, T_SA, T_Load, T_TC, T_Accel},
* accelerator-side bottlenecks -> ``balance_work``,
* Feature-Loader bottleneck -> ``balance_thread``,
* CPU Sampler / CPU Trainer bottlenecks -> ``balance_work`` if the fastest
  (or fastest+second) stages are accelerator-side, else ``balance_thread``.

``balance_work`` conserves the total mini-batch size and
``balance_thread`` the total CPU thread count.  The code is the reference's,
line for line, so both packages take the same decisions on the same times.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["StageTimes", "Assignment", "DRMEngine"]


@dataclasses.dataclass
class StageTimes:
    """Execution times (seconds) collected by the Runtime for one iteration."""
    t_sa: float = 0.0    # Sampling on Accelerator
    t_sc: float = 0.0    # Sampling on CPU
    t_load: float = 0.0  # Feature Loading (CPU)
    t_tran: float = 0.0  # Data Transfer (PCIe)
    t_tc: float = 0.0    # Training on CPU
    t_ta: float = 0.0    # Training on Accelerator
    # storage-I/O stall inside the load stage: aggregate gather-thread
    # seconds spent faulting cold (unprefetched) mmap pages.  Summed
    # across the loader's pool threads, so under a multi-threaded chunked
    # gather it can exceed the wall-clock t_load — compare magnitudes,
    # not as a strict subset.  Kept separate so the DRM (and anything
    # reading StageTimes) can tell a compute-bound Feature Loader from
    # one starved on the storage tier; the background window prefetcher
    # exists to drive this toward 0.
    t_load_stall: float = 0.0

    @property
    def t_accel(self) -> float:
        return max(self.t_tran, self.t_ta)

    def iteration_time(self) -> float:
        return max(self.t_sa, self.t_sc, self.t_load, self.t_tran,
                   self.t_tc, self.t_ta)


@dataclasses.dataclass
class Assignment:
    """Mutable workload/thread state the DRM engine fine-tunes."""
    cpu_batch: int                    # rows trained by the CPU trainer
    accel_batch: int                  # rows trained by EACH accelerator
    n_accel: int
    sample_frac_accel: float          # share of sampling done on accel
    threads: Dict[str, int]           # {"sample": k, "load": k, "train": k}

    @property
    def total_batch(self) -> int:
        return self.cpu_batch + self.accel_batch * self.n_accel

    def copy(self) -> "Assignment":
        return Assignment(self.cpu_batch, self.accel_batch, self.n_accel,
                          self.sample_frac_accel, dict(self.threads))


class DRMEngine:
    def __init__(self, assignment: Assignment, damping: float = 0.25,
                 min_accel_batch: int = 0, history: int = 2):
        self.assign = assignment
        self.damping = damping
        self.min_accel_batch = min_accel_batch
        self.history = history
        self.log: List[Tuple[StageTimes, str, Assignment]] = []

    # -------------------------------------------------------------- actions

    def _balance_work_train(self, times: StageTimes) -> str:
        """Move mini-batch rows between the CPU trainer and accelerators."""
        a = self.assign
        if a.n_accel <= 0:
            # no accelerator to trade rows with: any delta added to
            # accel_batch contributes accel_batch * 0 to total_batch, so
            # the conservation invariant would silently lose rows
            return "balance_work train: no accelerators (no-op)"
        slow_is_cpu = times.t_tc > times.t_accel
        t_slow = max(times.t_tc, times.t_accel)
        t_fast = max(min(times.t_tc, times.t_accel), 1e-9)
        imbalance = (t_slow - t_fast) / (t_slow + t_fast)
        if slow_is_cpu:
            delta = max(1, int(a.cpu_batch * imbalance * self.damping))
            delta = min(delta, a.cpu_batch)
            a.cpu_batch -= delta
            # spread over accelerators, conserving the total
            per = delta // max(a.n_accel, 1)
            rem = delta - per * max(a.n_accel, 1)
            a.accel_batch += per
            a.cpu_batch += rem  # leftover stays on CPU: exact conservation
            return f"balance_work train: cpu->accel {delta - rem} rows"
        else:
            delta = max(1, int(a.accel_batch * imbalance * self.damping))
            delta = min(delta, max(0, a.accel_batch - self.min_accel_batch))
            a.accel_batch -= delta
            a.cpu_batch += delta * max(a.n_accel, 1)
            return f"balance_work train: accel->cpu {delta}x{a.n_accel} rows"

    def _balance_work_sample(self, times: StageTimes) -> str:
        """Shift sampling share between CPU and accelerator samplers."""
        a = self.assign
        if times.t_sc == times.t_sa:
            # balanced pair (including both 0 in a probe iteration): any
            # move is drift.  Without this, the 1e-9 clamp on t_fast made
            # step negative and the t_sc > t_sa branch below — False at
            # equality — *added* damping to the accel share every call.
            return "balance_work sample: balanced (no-op)"
        t_slow = max(times.t_sc, times.t_sa)
        t_fast = max(min(times.t_sc, times.t_sa), 1e-9)
        step = self.damping * (t_slow - t_fast) / (t_slow + t_fast)
        if times.t_sc > times.t_sa:
            a.sample_frac_accel = min(1.0, a.sample_frac_accel + step)
            return f"balance_work sample: cpu->accel {step:.3f}"
        a.sample_frac_accel = max(0.0, a.sample_frac_accel - step)
        return f"balance_work sample: accel->cpu {step:.3f}"

    def _balance_thread(self, fastest_stage: str, bottleneck_stage: str) -> str:
        """Move one thread from the fastest CPU task to the bottleneck."""
        a = self.assign
        src = fastest_stage
        dst = bottleneck_stage
        if src == dst or a.threads.get(src, 0) <= 1:
            return "balance_thread: no-op (src exhausted)"
        a.threads[src] -= 1
        a.threads[dst] = a.threads.get(dst, 0) + 1
        return f"balance_thread: {src}->{dst}"

    # ------------------------------------------------------------ Algorithm 1

    def step(self, times: StageTimes) -> Assignment:
        t_accel = times.t_accel                          # line 1
        # Balance on the load stage's *compute* time: the storage-stall
        # share (t_load_stall) is seconds the gather threads sat faulting
        # cold mmap pages, which no thread/row rebalance can shrink — the
        # prefetcher exists for that.  Folding it in made a stall-bound
        # loader look like the system bottleneck, stealing threads (or
        # rows, via the fastest-cpu-task ranking) from trainers that were
        # not actually slow.  Stall is pool-thread-summed and can exceed
        # the wall-clock t_load, hence the clamp at 0.
        t_load_eff = max(times.t_load - times.t_load_stall, 0.0)
        stages = {"t_sc": times.t_sc, "t_sa": times.t_sa,
                  "t_load": t_load_eff, "t_tc": times.t_tc,
                  "t_accel": t_accel}
        # stages with zero time are inactive (e.g. no accelerator sampler)
        # and cannot be "fastest" — Algorithm 1 assumes all stages exist.
        active = {k: v for k, v in stages.items() if v > 0.0} or stages
        ranked = sorted(active.items(), key=lambda kv: kv[1], reverse=True)
        bottleneck = ranked[0][0]                        # line 5
        fastest = ranked[-1][0]                          # line 3
        second = ranked[-2][0] if len(ranked) > 1 else fastest  # line 4
        cpu_stages = {"t_sc": "sample", "t_load": "load", "t_tc": "train"}
        # thread-donor ranking over ACTIVE CPU stages only, judged on the
        # raw measured time (a stage that never ran — t_tc == 0 with no
        # CPU trainer — must not donate forever), but ranked on the
        # effective value so a stall-clamped loader still donates (its
        # threads sat faulting pages, not computing)
        raw = {"t_sc": times.t_sc, "t_load": times.t_load,
               "t_tc": times.t_tc}
        cpu_active = [(k, stages[k]) for k in cpu_stages if raw[k] > 0.0]
        cpu_ranked = sorted(cpu_active
                            or [(k, stages[k]) for k in cpu_stages],
                            key=lambda kv: kv[1])
        fastest_cpu_task = cpu_ranked[0][0]              # line 8

        if bottleneck == "t_sa":                         # line 11
            action = self._balance_work_sample(times)
        elif bottleneck == "t_accel":                    # line 13
            action = self._balance_work_train(times)
        elif bottleneck == "t_load":                     # line 15
            action = self._balance_thread(cpu_stages[fastest_cpu_task], "load")
        elif bottleneck == "t_sc":                       # line 17
            if fastest == "t_sa":
                action = self._balance_work_sample(times)
            elif fastest == "t_accel" and second == "t_sa":
                action = self._balance_work_sample(times)
            else:
                action = self._balance_thread(cpu_stages[fastest_cpu_task],
                                              "sample")
        elif bottleneck == "t_tc":                       # line 25
            if fastest == "t_accel":
                action = self._balance_work_train(times)
            elif fastest == "t_sa" and second == "t_accel":
                action = self._balance_work_train(times)
            else:
                action = self._balance_thread(cpu_stages[fastest_cpu_task],
                                              "train")
        else:  # pragma: no cover
            action = "no-op"

        self.log.append((times, action, self.assign.copy()))
        if len(self.log) > 512:
            del self.log[:-256]
        return self.assign
