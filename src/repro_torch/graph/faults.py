"""Deterministic fault injection for the storage and prefetch data plane.

Port of ``repro/graph/faults.py``, numpy only; a schedule written as JSON
loads in both packages, field for field.

Failure model & degraded modes
==============================

The data plane is asynchronous (the mmap storage tier, the background
``WindowPrefetcher``, the staged cache refresh, the ``PrefetchPipeline``
stage threads, the loader's thread-pool gathers).  This module is the chaos
half of its robustness story: a **seeded, schedulable** ``FaultInjector``
that the data-plane components consult at well-defined hook points, so
every failure mode has a deterministic, replayable test.  The protocol the
faults exercise:

  * **retries** — transient storage I/O errors (``OSError`` from an mmap
    gather or a prefetch read) are retried with bounded, jittered
    exponential backoff inside ``MmapFeatures`` (``io_retries`` /
    ``io_retry_seconds`` counters).  A fault that clears within the
    retry budget is invisible to training: losses stay bit-identical.
  * **degrades** — advisory background components never kill a run.  A
    prefetch worker that dies is restarted within a budget; past the
    budget the trainer stops submitting, prices ``prefetch_overlap`` at
    0 and continues with synchronous (cold) loads.  A permanently
    unreadable window blob falls back to a bounded gather from the
    spill's backing ``FeatureSource``.  madvise/fadvise hint failures
    only increment counters.  Degraded state surfaces through the
    trainer's ``health()`` report — never through silence.
  * **raises** — correctness-critical failures still raise: a load-path
    gather whose retries AND fallback are exhausted.

Every hook in the table below fires in the port: inside ``MmapFeatures``,
``WindowPrefetcher``, ``FeatureCache.stage`` and ``PrefetchPipeline``,
reached through the trainer's ``fault_injector`` argument.  The names are
the reference's, so one schedule describes both packages.

Hook points (``FaultSpec.op``):

  ====================  ====================================================
  ``storage.take``      each per-partition window read in ``MmapFeatures
                        .take`` (one fire per retry attempt)
  ``storage.prefetch``  each per-partition pre-fault in ``prefetch_rows``
  ``storage.madvise``   each madvise hint (failure increments
                        ``madvise_failures``)
  ``storage.fadvise``   each posix_fadvise in ``drop_page_cache`` (failure
                        increments ``fadvise_failures``)
  ``storage.spill``     each partition write in ``MmapFeatures.spill``
                        (ENOSPC path: partial blobs are cleaned up)
  ``prefetch.worker``   each ``WindowPrefetcher`` work item (``kill``
                        terminates the worker thread)
  ``refresh.stage``     each ``FeatureCache.stage()`` call
  ``pipeline.<stage>``  each ``PrefetchPipeline`` stage invocation
                        (``delay`` wedges a stage for the watchdog;
                        long delays force queue-full storms upstream)
  ====================  ====================================================

Determinism: every hook keeps a **per-op call counter** under a lock, and
a spec matches by call index (``start`` / ``count``), so a schedule fires
on exactly the same calls in every run regardless of thread interleaving.
Probabilistic specs (``probability < 1``) draw from a per-spec
``np.random.default_rng`` seeded from ``(seed, op, spec index)`` — still a
pure function of the per-op call index.  ``op`` enters that seed through
Python's ``hash``, as in the reference; string hashes are salted per
process unless ``PYTHONHASHSEED`` is set, so a probabilistic schedule
replays exactly within one process (where both packages draw alike) and
across processes only under a fixed ``PYTHONHASHSEED``.
"""
from __future__ import annotations

import dataclasses
import errno as _errno
import json
import threading
import time
from typing import Any, ClassVar, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..annotations import guarded_by

__all__ = ["FaultSpec", "FaultInjector", "WorkerKilled"]


class WorkerKilled(BaseException):
    """Injected hard death of a background worker thread.

    Deliberately a ``BaseException``: ordinary per-item ``except
    Exception`` recovery must not swallow it — it models the thread
    dying (OOM-kill, segfaulted native gather), not a failed work item.
    Supervisors detect the dead thread and restart within their budget.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire on calls ``start .. start+count-1`` of
    hook ``op`` (per-op call indices, 0-based).

    ``kind``:
      * ``"transient"`` — raise ``OSError(errno)`` on the matching calls
        (a retry after the window succeeds),
      * ``"permanent"`` — raise ``OSError(errno)`` on every call from
        ``start`` on (``count`` ignored),
      * ``"delay"``     — sleep ``delay`` seconds (I/O latency injection /
        queue-full storms / watchdog wedges),
      * ``"kill"``      — raise ``WorkerKilled`` (terminates the worker
        thread that hit it).

    ``probability < 1`` fires only on that fraction of matching calls,
    drawn deterministically from the injector seed.
    """
    op: str
    kind: str = "transient"
    start: int = 0
    count: int = 1
    delay: float = 0.0
    errno: int = _errno.EIO
    probability: float = 1.0
    message: str = ""

    _KINDS: ClassVar[Tuple[str, ...]] = (
        "transient", "permanent", "delay", "kill")

    def __post_init__(self) -> None:
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {self._KINDS}")

    def matches(self, call_index: int) -> bool:
        if call_index < self.start:
            return False
        if self.kind == "permanent":
            return True
        return call_index < self.start + self.count

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


# schedule/seed/_by_op/_rngs are immutable after __init__ (to_json
# and the spec lookups read them lock-free by design); everything
# mutable is declared below.
@guarded_by("_lock", "calls", "injected", "faults_raised",
            "delays_injected", "total_delay_seconds")
class FaultInjector:
    """Seeded, schedulable fault injector consulted at data-plane hooks.

    Components hold an optional ``fault_injector`` attribute and call
    ``fire(op)`` at their hook point; with no schedule entry for ``op``
    the call is a dict lookup and a counter increment.  All mutation is
    under one lock, so concurrent hooks (pool threads, the prefetch
    worker, pipeline stages) each see a consistent per-op call index.

    Observability: ``calls`` (per-op hook invocations), ``injected``
    (per-op faults applied), ``faults_raised`` / ``delays_injected`` /
    ``total_delay_seconds`` aggregates, and ``report()`` for the whole
    picture.
    """

    def __init__(self,
                 schedule: Sequence[Union[FaultSpec,
                                          Dict[str, Any]]] = (),
                 seed: int = 0) -> None:
        self.seed = int(seed)
        self.schedule: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s)
            for s in schedule]
        self._by_op: Dict[str, List[Tuple[int, FaultSpec]]] = {}
        for i, spec in enumerate(self.schedule):
            self._by_op.setdefault(spec.op, []).append((i, spec))
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self.faults_raised = 0
        self.delays_injected = 0
        self.total_delay_seconds = 0.0
        # per-spec deterministic rng for probabilistic specs: seeded from
        # (seed, op, spec index) so decisions depend only on the per-op
        # call order, never on wall clock or thread identity
        self._rngs: Dict[int, np.random.Generator] = {
            i: np.random.default_rng(
                np.random.SeedSequence((self.seed, hash(s.op) & 0x7FFFFFFF,
                                        i)))
            for i, s in enumerate(self.schedule) if s.probability < 1.0}

    # ------------------------------------------------------------- loading

    @classmethod
    def from_json(cls,
                  path_or_obj: Union[str, Dict[str, Any],
                                     List[Dict[str, Any]]],
                  seed: Optional[int] = None) -> "FaultInjector":
        """Build from a JSON schedule: either a list of FaultSpec dicts or
        ``{"seed": int, "schedule": [...]}`` (a file path or a parsed
        object)."""
        obj = path_or_obj
        if isinstance(obj, str):
            with open(obj) as fh:
                obj = json.load(fh)
        if isinstance(obj, dict):
            sched = obj.get("schedule", [])
            seed = obj.get("seed", 0) if seed is None else seed
        else:
            sched = obj
        return cls(sched, seed=seed or 0)

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "schedule": [s.to_dict() for s in self.schedule]})

    # -------------------------------------------------------------- firing

    def fire(self, op: str) -> None:
        """Consult the schedule for one call of hook ``op``.

        May sleep (``delay``), raise ``OSError`` (``transient`` /
        ``permanent``) or raise ``WorkerKilled`` (``kill``); returns
        normally when no spec matches this call index.  When several
        specs match the same call, delays apply first (latency precedes
        the error a slow device eventually returns), then the first
        raising spec in schedule order wins.
        """
        with self._lock:
            idx = self.calls.get(op, 0)
            self.calls[op] = idx + 1
            specs = self._by_op.get(op)
            if not specs:
                return
            actions: List[FaultSpec] = []
            for spec_i, spec in specs:
                if not spec.matches(idx):
                    continue
                if spec.probability < 1.0 and \
                        self._rngs[spec_i].random() >= spec.probability:
                    continue
                actions.append(spec)
            if not actions:
                return
            delay = sum(s.delay for s in actions if s.kind == "delay")
            raising = next((s for s in actions if s.kind != "delay"), None)
            self.injected[op] = self.injected.get(op, 0) + len(actions)
            if delay:
                self.delays_injected += 1
                self.total_delay_seconds += delay
            if raising is not None:
                self.faults_raised += 1
        # act OUTSIDE the lock: a long injected delay must not serialize
        # every other hook in the process behind it
        if delay:
            time.sleep(delay)
        if raising is None:
            return
        msg = raising.message or (
            f"injected {raising.kind} fault on {op} (call {idx})")
        if raising.kind == "kill":
            raise WorkerKilled(msg)
        raise OSError(raising.errno, msg)

    # ----------------------------------------------------------- reporting

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "calls": dict(self.calls),
                "injected": dict(self.injected),
                "faults_raised": self.faults_raised,
                "delays_injected": self.delays_injected,
                "total_delay_seconds": self.total_delay_seconds,
            }
