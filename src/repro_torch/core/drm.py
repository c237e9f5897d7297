"""Dynamic Resource Management (paper Section IV-A, Algorithm 1).

Port of ``repro/core/drm.py``: the engine and the model-predictive knob
autotuner (``KnobAutoTuner``).  A bottleneck-guided runtime
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
import itertools
from typing import Callable, Dict, List, Optional, Tuple

from .perfmodel import CalibratedKnobModel, KnobBounds, KnobState

__all__ = ["StageTimes", "Assignment", "DRMEngine", "KnobProposal",
           "KnobAutoTuner", "knob_neighbors"]


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

    # ----------------------------------------------- online knob search

    def propose_knobs(self, model: CalibratedKnobModel, current: KnobState,
                      bounds: KnobBounds, min_gain: float = 0.02,
                      veto: Optional[set] = None
                      ) -> Optional["KnobProposal"]:
        """One step of the model-predictive knob search: enumerate the
        bounded single-knob neighborhood of ``current``, price each
        candidate with the calibrated Eq. 7/8 model, and return the best
        move — or None when nothing beats the current knobs by at least
        ``min_gain`` (relative).  Pure search: applying (and verifying,
        and possibly rolling back) the proposal is the caller's job —
        see ``KnobAutoTuner``.  ``veto`` names move keys temporarily
        blocked after a measured rollback."""
        baseline = model.predict(current)
        best: Optional[Tuple[float, str, KnobState]] = None
        for move, cand in knob_neighbors(current, bounds):
            if veto and move in veto:
                continue
            pred = model.predict(cand)
            if best is None or pred < best[0]:
                best = (pred, move, cand)
        if best is None:
            return None
        pred, move, cand = best
        if pred > baseline * (1.0 - min_gain):
            return None
        return KnobProposal(knobs=cand, move=move, predicted=pred,
                            baseline=baseline)


def knob_neighbors(k: KnobState, b: KnobBounds
                   ) -> List[Tuple[str, KnobState]]:
    """Bounded single-knob moves from ``k``: geometric steps on the
    queue/window/cadence knobs (the useful scales span orders of
    magnitude) and one-thread transfers between stages (conserving the
    total, like balance_thread).  Every returned state satisfies
    ``b.contains``; move keys are direction-stable ("knob:up") so a
    vetoed direction stays vetoed across magnitudes."""
    out: List[Tuple[str, KnobState]] = []

    def add(move: str, **delta) -> None:
        cand = dataclasses.replace(k, **delta)
        if cand != k and b.contains(cand):
            out.append((move, cand))

    p = k.prefetch_windows
    add("prefetch_windows:up", prefetch_windows=min(
        max(2 * p, 1), b.prefetch_windows[1]))
    add("prefetch_windows:down", prefetch_windows=max(
        p // 2, b.prefetch_windows[0]))
    w = k.mmap_lru_windows
    add("mmap_lru_windows:up", mmap_lru_windows=min(
        max(2 * w, 1), b.mmap_lru_windows[1]))
    add("mmap_lru_windows:down", mmap_lru_windows=max(
        w // 2, b.mmap_lru_windows[0]))
    r = k.refresh_period
    add("refresh_period:up", refresh_period=min(
        max(2 * r, 1), b.refresh_period[1]))
    add("refresh_period:down", refresh_period=max(
        r // 2, b.refresh_period[0]))
    f = k.refresh_frac
    add("refresh_frac:up", refresh_frac=min(2.0 * f, b.refresh_frac[1]))
    add("refresh_frac:down", refresh_frac=max(f / 2.0, b.refresh_frac[0]))
    stages = ("sample", "load", "train")
    for src, dst in itertools.permutations(stages, 2):
        s_val = getattr(k, f"{src}_threads")
        if s_val <= b.min_stage_threads:
            continue
        add(f"threads:{src}->{dst}",
            **{f"{src}_threads": s_val - 1,
               f"{dst}_threads": getattr(k, f"{dst}_threads") + 1})
    return out


@dataclasses.dataclass(frozen=True)
class KnobProposal:
    """One bounded knob move with its model pricing."""
    knobs: KnobState
    move: str                      # direction-stable key, e.g. "threads:sample->load"
    predicted: float               # model iteration time at `knobs`
    baseline: float                # model iteration time at current knobs


@dataclasses.dataclass
class _Trial:
    """A proposal applied but not yet verified against measurement."""
    prev: KnobState                # exact pre-move state (rollback target)
    knobs: KnobState
    move: str
    baseline_wall: float           # measured mean iter time before the move
    predicted: float
    baseline_predicted: float
    measured_wall: float = 0.0     # filled when the trial window closes


class KnobAutoTuner:
    """Closes the DRM loop over the hand-set knobs: measure a window,
    calibrate the Eq. 7/8 model on it, apply the best bounded single-knob
    move, verify against the next *measured* window, keep or roll back.

    State machine, advanced once per iteration boundary by ``step``:

      MEASURE  — accumulate ``interval`` iterations of StageTimes;
      DECIDE   — window closed: if a trial is pending, accept it (keep
                 the knobs) unless the measured mean regressed past
                 ``baseline_wall x (1 + hysteresis)``, in which case the
                 exact pre-move KnobState is returned for re-application
                 and the move direction is vetoed for ``veto_windows``
                 windows; then (either way) calibrate a fresh model via
                 ``model_fn`` and search for the next proposal.

    The tuner never touches workload shares, RNG streams or batch
    composition — every knob it moves is performance-only, so losses
    stay bit-identical to a static-knob run (the bench_autotune gate).

    Threading: driven only from the training thread at iteration
    boundaries; no internal locks by design (single-caller contract,
    like the DRMEngine it extends).
    """

    def __init__(self, engine: DRMEngine, bounds: KnobBounds,
                 interval: int = 3, hysteresis: float = 0.10,
                 min_gain: float = 0.02, warmup_windows: int = 1,
                 veto_windows: int = 4):
        self.engine = engine
        self.bounds = bounds
        self.interval = max(1, int(interval))
        self.hysteresis = float(hysteresis)
        self.min_gain = float(min_gain)
        self.warmup_windows = max(0, int(warmup_windows))
        self.veto_windows = max(1, int(veto_windows))
        self._win: List[StageTimes] = []
        self._windows_seen = 0
        self._trial: Optional[_Trial] = None
        self._veto: Dict[str, int] = {}      # move key -> windows left
        self.accepted: List[_Trial] = []
        self.rollbacks = 0
        self.trials = 0
        self.log: List[Tuple[str, str]] = []  # (event, move/detail)

    @staticmethod
    def _mean_times(win: List[StageTimes]) -> StageTimes:
        n = max(len(win), 1)
        return StageTimes(
            t_sa=sum(t.t_sa for t in win) / n,
            t_sc=sum(t.t_sc for t in win) / n,
            t_load=sum(t.t_load for t in win) / n,
            t_tran=sum(t.t_tran for t in win) / n,
            t_tc=sum(t.t_tc for t in win) / n,
            t_ta=sum(t.t_ta for t in win) / n,
            t_load_stall=sum(t.t_load_stall for t in win) / n)

    def step(self, times: StageTimes,
             model_fn: Callable[[StageTimes, int], CalibratedKnobModel],
             current: KnobState) -> Optional[KnobState]:
        """Feed one iteration's measured times; returns a KnobState the
        caller must apply (a new proposal OR an exact rollback), or None.
        ``model_fn(mean_times, window_iters)`` builds the calibrated
        model from the window's measured signals."""
        self._win.append(times)
        if len(self._win) < self.interval:
            return None
        mean = self._mean_times(self._win)
        wall = sum(t.iteration_time() for t in self._win) / len(self._win)
        iters = len(self._win)
        self._win = []
        self._windows_seen += 1
        for key in [m for m, left in self._veto.items() if left <= 1]:
            del self._veto[key]
        for key in self._veto:
            self._veto[key] -= 1
        if self._trial is not None:
            tr, self._trial = self._trial, None
            tr.measured_wall = wall
            if wall > tr.baseline_wall * (1.0 + self.hysteresis):
                # measured regression: restore the exact pre-move state
                # and veto the direction so the search does not thrash
                self.rollbacks += 1
                self._veto[tr.move] = self.veto_windows
                self.log.append(("rollback", tr.move))
                return tr.prev
            self.accepted.append(tr)
            self.log.append(("accept", tr.move))
        if self._windows_seen <= self.warmup_windows:
            return None
        model = model_fn(mean, iters)
        prop = self.engine.propose_knobs(model, current, self.bounds,
                                         min_gain=self.min_gain,
                                         veto=set(self._veto))
        if prop is None:
            return None
        self.trials += 1
        self._trial = _Trial(prev=current, knobs=prop.knobs,
                             move=prop.move, baseline_wall=wall,
                             predicted=prop.predicted,
                             baseline_predicted=prop.baseline)
        self.log.append(("try", prop.move))
        return prop.knobs

    def report(self) -> Dict[str, object]:
        """Summary for benches and launchers: counts, the accepted trajectory
        (with model pricing) and the live veto set."""
        return {
            "trials": self.trials,
            "accepted": len(self.accepted),
            "rollbacks": self.rollbacks,
            "moves": [{"move": t.move,
                       "predicted": t.predicted,
                       "baseline_predicted": t.baseline_predicted,
                       "baseline_wall": t.baseline_wall,
                       "measured_wall": t.measured_wall}
                      for t in self.accepted],
            "vetoed": sorted(self._veto),
        }
