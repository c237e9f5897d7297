"""Background storage-I/O prefetch (async partition-window pre-faulting).

Port of ``repro/graph/prefetch.py``, numpy and threads only.

HyScale-GNN's two-stage prefetch (paper §IV-B) overlaps the Feature
Loader and Data Transfer with accelerator compute, but on the disk tier
the load stage itself still blocks on cold mmap page faults.  The TFP
pipeline *knows* batch i+1's frontier (its sample stage runs while batch
i loads — paper Fig. 7), so a DistDGL-style background I/O thread can
pre-fault the windows batch i+1 will touch while batch i's gather runs:
by the time the load stage reaches batch i+1, its pages are warm and the
gather never waits on the storage device.

``WindowPrefetcher`` is that thread.  It wraps any FeatureSource
exposing ``prefetch_rows`` (the out-of-core ``MmapFeatures``) and:

  * ``submit(rows)`` — enqueue one future gather's row ids.  Non-blocking
    and lossy by design: a full queue drops the request (``dropped``
    counter) rather than ever stalling the sample stage — prefetch is
    advisory, the consumer's gather is always correct without it.
  * cross-batch dedup (``dedup_history > 0``): consecutive frontiers
    overlap heavily (hub nodes recur in nearly every batch), so the
    prefetcher remembers the ids of the last few submits and strips
    already-warm rows from each new one before it reaches the worker —
    the background read volume drops by the cross-batch duplication
    factor.  ``resubmitted_rows_skipped`` counts the stripped rows.  The
    memory is advisory like everything else here: any LRU eviction on
    the source invalidates the warm assumption, so the history clears
    whenever ``source.window_evictions`` moves.
  * the worker thread drains the queue calling
    ``source.prefetch_rows`` (a readahead gather of exactly the rows a
    future ``take`` will touch).
  * ``close()`` is idempotent and safe with a half-drained queue: the
    stop flag makes the worker skip remaining work, a sentinel ends it,
    and a second ``close()`` returns immediately.

Failure model & degraded modes
------------------------------

Two failure classes, handled differently:

  * a prefetch *item* fails (``source.prefetch_rows`` raised — e.g. a
    spill blob deleted mid-run, past the storage tier's own retries):
    the error is latched in ``error`` (appended to ``errors``), the
    worker keeps draining so a blocked producer / ``close()`` never
    deadlocks, and supervision decides what happens next;
  * the worker *thread* dies (``WorkerKilled`` from fault injection, or
    any raise escaping the item handler): detected by ``submit`` via the
    dead thread.

Supervision runs inline at each ``submit`` (``_supervise``): a failed or
dead worker is restarted with exponential backoff up to
``restart_budget`` times (``restarts`` counter).  Past the budget the
prefetcher goes permanently ``failed``: with the legacy strict contract
(``raise_on_failure=True``, the class default) the next ``submit``
raises with the first error chained; under a supervising trainer
(``raise_on_failure=False``) ``submit`` just returns False forever — the
trainer degrades to synchronous loads and re-prices ``prefetch_overlap``
to 0, surfacing the state through ``health()``/``healthy`` instead of an
exception.  The default ``restart_budget=0`` keeps the strict contract:
the first failure latches and the next submit raises.

``wait_idle`` exists for tests/benchmarks that need the asynchronous
pre-fault to have *happened* before measuring (the trainer never calls
it — overlapping is the whole point).  Its predicate also releases on a
dead worker, so an injected kill cannot wedge a waiting test.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import List, Optional

import numpy as np

from ..annotations import guarded_by

__all__ = ["WindowPrefetcher"]

_SENTINEL = object()


# Deliberately UNGUARDED shared state (not declared below, so the lint
# does not police it):
#   * error / errors / failed / restarts — the failure latch: written by
#     the worker, read by the single-producer supervisor.  A torn read is
#     impossible (reference assignment) and the supervisor re-checks
#     under its own control flow; taking _cv in the hot submit path for
#     an advisory latch is not worth it.
#   * _history / _evictions_seen / resubmitted_rows_skipped / dropped /
#     max_queue — producer-side only: submit() is single-producer by
#     contract, and resize() runs on the same (training) thread at
#     iteration boundaries.
@guarded_by("_cv", "_pending", "completed", "submitted")
class WindowPrefetcher:
    """Background thread pre-faulting partition windows for future gathers."""

    def __init__(self, source, max_queue: int = 4,
                 dedup_history: int = 0,
                 name: str = "window-prefetch",
                 restart_budget: int = 0,
                 restart_backoff: float = 0.02,
                 raise_on_failure: bool = True,
                 fault_injector=None):
        if not hasattr(source, "prefetch_rows"):
            raise TypeError(
                f"{type(source).__name__} has no prefetch_rows: the window "
                "prefetcher only serves page-faulting (mmap) sources")
        self.source = source
        self._name = name
        self.max_queue = max(1, int(max_queue))
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._cv = threading.Condition()
        self._pending = 0              # submitted but not yet processed
        self._stop = threading.Event()
        self._closed = False
        self.fault_injector = fault_injector
        self.restart_budget = int(restart_budget)
        self.restart_backoff = float(restart_backoff)
        self.raise_on_failure = bool(raise_on_failure)
        self.error: Optional[BaseException] = None
        self.errors: List[BaseException] = []   # every failure, in order
        self.restarts = 0              # worker respawns performed
        self.failed = False            # permanently degraded (budget spent)
        self.submitted = 0
        self.completed = 0
        self.dropped = 0               # queue-full discards (by design)
        self.resubmitted_rows_skipped = 0   # cross-batch dedup strips
        # last N successfully-submitted id sets (producer-side only:
        # submit() is single-producer, so no lock is needed)
        self._history: "collections.deque" = collections.deque(
            maxlen=max(0, int(dedup_history)) or None)
        self._dedup = int(dedup_history) > 0
        self._evictions_seen = int(getattr(source, "window_evictions", 0))
        self._thread = self._spawn()

    def _spawn(self) -> threading.Thread:
        t = threading.Thread(target=self._run, daemon=True, name=self._name)
        t.start()
        return t

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            # after a failure (or during close) keep draining without
            # working, so a blocked producer / close() never deadlocks
            if self.error is None and not self._stop.is_set():
                try:
                    if self.fault_injector is not None:
                        self.fault_injector.fire("prefetch.worker")
                    self.source.prefetch_rows(item)
                    with self._cv:
                        self.completed += 1
                except Exception as e:
                    # item failure: latch, keep the thread draining
                    self.errors.append(e)
                    self.error = e
                except BaseException as e:
                    # thread death (injected WorkerKilled): record it and
                    # END the thread — a per-item handler must not absorb
                    # it.  The pending count still drops so waiters
                    # release; supervision respawns within its budget.
                    self.errors.append(e)
                    self.error = e
                    with self._cv:
                        self._pending -= 1
                        self._cv.notify_all()
                    return
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    # ------------------------------------------------------- supervision

    @property
    def healthy(self) -> bool:
        """True while the prefetcher can still serve submits (possibly
        after a restart); False once permanently failed or closed."""
        return not self.failed and not self._closed

    def _supervise(self) -> bool:
        """Inline supervisor, run at each submit: restart a failed/dead
        worker within ``restart_budget`` (exponential backoff between
        restarts), else mark the prefetcher permanently ``failed``.
        Returns True when the worker is (again) serviceable."""
        if self.failed:
            return False
        dead = not self._thread.is_alive() and not self._closed
        if self.error is None and not dead:
            return True
        if self.restarts >= self.restart_budget:
            self.failed = True
            return False
        # budgeted restart: back off, clear the latch, respawn if needed
        time.sleep(self.restart_backoff * (2.0 ** self.restarts))
        self.restarts += 1
        self.error = None
        if not self._thread.is_alive():
            # the dead worker abandoned whatever sat in the queue; any
            # such items were already un-counted from _pending only if
            # processed — drain leftovers so the new worker starts clean
            leftovers = 0
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL:
                    leftovers += 1
            if leftovers:
                with self._cv:
                    self._pending -= leftovers
                    self._cv.notify_all()
            self._thread = self._spawn()
        return True

    # ----------------------------------------------------------- producer

    def submit(self, rows: np.ndarray) -> bool:
        """Enqueue one future gather's rows for background pre-faulting.

        Returns True when enqueued, False when dropped (queue full,
        prefetcher closed, or permanently failed with
        ``raise_on_failure=False``).  With the strict contract
        (``raise_on_failure=True``) a prefetcher that failed past its
        restart budget raises — the advisory thread must not hide a
        broken storage tier from an unsupervised caller."""
        if not self._supervise():
            if self.raise_on_failure:
                raise RuntimeError(
                    "window prefetch worker failed; storage tier is broken"
                ) from (self.errors[0] if self.errors else self.error)
            return False
        if self._closed:
            return False
        rows = np.asarray(rows)
        work = rows
        if self._dedup:
            # an eviction on the source means some remembered window is
            # cold again — the whole memory is suspect, drop it
            ev = int(getattr(self.source, "window_evictions", 0))
            if ev != self._evictions_seen:
                self._history.clear()
                self._evictions_seen = ev
            if self._history:
                warm = np.concatenate(list(self._history))
                work = rows[~np.isin(rows, warm)]
                # the worker may have evicted a window while the strip was
                # computed (prefetch_rows -> source LRU runs concurrently);
                # a moved eviction counter means the warm assumption behind
                # the strip is stale, so fall back to the full row set
                # rather than enqueue a prefetch that skips cold rows
                ev = int(getattr(self.source, "window_evictions", 0))
                if ev != self._evictions_seen:
                    self._history.clear()
                    self._evictions_seen = ev
                    work = rows
                else:
                    self.resubmitted_rows_skipped += rows.size - work.size
            if work.size == 0:
                # everything is already warm: the submit succeeded without
                # touching the worker; refresh the rows' recency
                self._history.append(rows)
                with self._cv:
                    self.submitted += 1
                return True
        with self._cv:
            try:
                self._q.put_nowait(work)
            except queue.Full:
                self.dropped += 1
                return False
            self._pending += 1
            self.submitted += 1
        if self._dedup:
            # remember the ORIGINAL ids (stripped rows are warm via an
            # earlier entry, and this entry must keep them warm once that
            # one ages out) — and only on enqueue: a dropped submit
            # prefetches nothing, so it must not poison the memory
            self._history.append(rows)
        return True

    def resize(self, max_queue: int) -> None:
        """Change the queue depth in place (DRM knob auto-tuning).
        Queued work is never discarded: shrinking only makes the queue
        stop accepting new submits (drops, by the advisory contract)
        until it drains below the new bound.  queue.Queue re-reads
        ``maxsize`` under its own mutex on every put, so swapping it
        there is exactly the synchronization the queue itself uses."""
        depth = max(1, int(max_queue))
        with self._q.mutex:
            self._q.maxsize = depth
            self._q.not_full.notify_all()
        self.max_queue = depth

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request was processed (or failed,
        or the worker died).  Test/benchmark hook — the training path
        never waits."""
        with self._cv:
            # the predicate lambda runs with _cv re-acquired by wait_for
            return self._cv.wait_for(
                lambda: (self._pending == 0  # noqa: RPR101 - locked by wait_for
                         or self.error is not None
                         or not self._thread.is_alive()),
                timeout)

    def close(self) -> None:
        """Stop the worker (idempotent; safe under a half-drained queue:
        remaining requests are drained unprocessed, never worked; safe
        after an injected worker death: no sentinel is forced into a
        possibly-full queue nobody drains)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread.is_alive():
            try:
                self._q.put_nowait(_SENTINEL)
            except queue.Full:
                # full queue with a live worker: it is mid-drain, a
                # blocking put resolves as soon as it takes the next item
                self._q.put(_SENTINEL)
            self._thread.join(timeout=30.0)

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass
