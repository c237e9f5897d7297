"""Two-stage feature prefetching / pipelined runtime (paper Section IV-B).

Port of ``repro/core/pipeline.py``.  Each stage runs in its own host
thread and hands items on through ``queue.Queue(maxsize=depth)``: with the
paper's default depth 2 the Feature Loader works on mini-batch i+2 while
the Data Transfer stage ships i+1 and the trainers execute i (paper
Fig. 7).  ``depth=0`` runs the stages one after another — the ablation
baseline of Fig. 11.

The consumer's wait for each item, from asking for it to having it, is
the span ``pipeline.wait`` (``repro_torch.trace``): the output queue's
get, or at ``depth=0`` the stages run inline.  A stage that raises stops
the feeder, every worker drains to its sentinel, and ``run()`` re-raises.

A stage that *wedges* (a gather stuck on a dead mount, an injected delay)
would hang the consumer; with ``watchdog_seconds > 0`` the consumer polls
its output queue and reads per-stage heartbeats, and a stage busy on one
item (or the feeder stuck pulling from its payload source) past the
deadline raises ``PipelineStallError`` naming the stage, how long it has
been stuck, every queue depth and the items each stage completed.  The
watchdog never fires while items keep arriving; 0 (the default) keeps the
blocking behaviour.  The fault hook ``pipeline.<stage>`` fires before each
stage invocation.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

from .. import trace

__all__ = ["PipelineItem", "Stage", "PrefetchPipeline", "PipelineStallError"]

_SENTINEL = object()


@dataclasses.dataclass
class PipelineItem:
    seq: int
    payload: Any


@dataclasses.dataclass
class Stage:
    name: str
    fn: Callable[[PipelineItem], PipelineItem]   # mutates/returns the item


class PipelineStallError(RuntimeError):
    """A pipeline stage (or the feeder) made no progress past the
    watchdog deadline.  Carries the wedged stage's name plus a queue /
    completion snapshot for diagnosis."""

    def __init__(self, stage: str, stalled_seconds: float,
                 watchdog_seconds: float, queue_depths: Dict[str, int],
                 completed: Dict[str, int]):
        self.stage = stage
        self.stalled_seconds = stalled_seconds
        self.watchdog_seconds = watchdog_seconds
        self.queue_depths = dict(queue_depths)
        self.completed = dict(completed)
        super().__init__(
            f"pipeline stage {stage!r} wedged: no progress for "
            f"{stalled_seconds:.1f}s (watchdog {watchdog_seconds:.1f}s); "
            f"queue depths {queue_depths}; items completed per stage "
            f"{completed}")


class PrefetchPipeline:
    """Chains stages over bounded queues; ``depth=0`` means sequential.

    Every ``run()`` threads its own queues, heartbeat dicts, error holder
    and stop event through the workers it spawns; all cross-thread
    handoffs ride the queues, whose put/get pairs order them, so the class
    has no shared state to guard.  Each heartbeat dict has one writer (its
    own stage thread); the watchdog only reads them, and a torn read costs
    one poll tick.  ``self._error`` is observability only, written after
    the run's threads are joined."""

    def __init__(self, stages: List[Stage], depth: int = 2,
                 watchdog_seconds: float = 0.0,
                 fault_injector=None):
        self.stages = stages
        self.depth = int(depth)
        self.watchdog_seconds = float(watchdog_seconds)
        self.fault_injector = fault_injector
        # the last run's failure: every run() has its own error holder, so
        # threads left over from an abandoned run never reach a later one
        self._error: Optional[BaseException] = None

    def _run_sequential(self, items: Iterable[PipelineItem]
                        ) -> Iterator[PipelineItem]:
        it = iter(items)
        while True:
            with trace.span("pipeline.wait"):
                item = next(it, _SENTINEL)
                if item is not _SENTINEL:
                    for st in self.stages:
                        if self.fault_injector is not None:
                            self.fault_injector.fire(f"pipeline.{st.name}")
                        item = st.fn(item)
            if item is _SENTINEL:
                return
            yield item

    def _worker(self, st: Stage, q_in: "queue.Queue", q_out: "queue.Queue",
                state: Dict[str, Optional[BaseException]],
                stop: threading.Event, hb: Dict[str, Any]) -> None:
        failed = False
        while True:
            item = q_in.get()
            if item is _SENTINEL:
                q_out.put(_SENTINEL)
                return
            if failed or stop.is_set():
                continue            # drain so the feeder never blocks
            try:
                # (busy, since) tells the watchdog a wedged stage from an
                # idle one
                hb["since"] = time.perf_counter()
                hb["busy"] = True
                if self.fault_injector is not None:
                    self.fault_injector.fire(f"pipeline.{st.name}")
                item = st.fn(item)
                hb["busy"] = False
                hb["done"] += 1
            except BaseException as e:  # handed to the consumer, re-raised
                hb["busy"] = False
                state["error"] = e
                stop.set()
                failed = True
                continue
            q_out.put(item)

    def _check_stall(self, beats: List[Dict[str, Any]],
                     qs: List["queue.Queue"],
                     stop: threading.Event) -> None:
        """Raise ``PipelineStallError`` if any busy stage (or the feeder's
        pull from its payload source) is past the watchdog deadline."""
        now = time.perf_counter()
        for hb in beats:
            if hb["busy"] and now - hb["since"] > self.watchdog_seconds:
                stop.set()
                depths = {}
                for i, q in enumerate(qs):
                    label = (self.stages[i].name if i < len(self.stages)
                             else "output") + "_in"
                    depths[label] = q.qsize()
                completed = {hb2["name"]: hb2["done"] for hb2 in beats}
                raise PipelineStallError(
                    hb["name"], now - hb["since"], self.watchdog_seconds,
                    depths, completed)

    def _next_out(self, qs: List["queue.Queue"], poll: Optional[float],
                  beats: List[Dict[str, Any]],
                  stop: threading.Event) -> Any:
        """The next item (or the sentinel) from the output queue, polled
        every ``poll`` seconds for a stall when the watchdog is on."""
        if poll is None:
            return qs[-1].get()
        while True:
            try:
                return qs[-1].get(timeout=poll)
            except queue.Empty:
                # nothing can unstick a wedged stage's thread, so give a
                # diagnosis instead of inheriting its hang
                self._check_stall(beats, qs, stop)

    def run(self, items: Iterable[PipelineItem]) -> Iterator[PipelineItem]:
        self._error = None
        if self.depth <= 0:
            yield from self._run_sequential(items)
            return
        state: Dict[str, Optional[BaseException]] = {"error": None}
        stop = threading.Event()
        qs: List["queue.Queue"] = [queue.Queue(maxsize=self.depth)
                                   for _ in range(len(self.stages) + 1)]
        beats: List[Dict[str, Any]] = [
            {"name": st.name, "busy": False, "since": 0.0, "done": 0}
            for st in self.stages]
        feed_hb: Dict[str, Any] = {"name": "feed", "busy": False,
                                   "since": 0.0, "done": 0}
        threads = [threading.Thread(target=self._worker,
                                    args=(st, qs[i], qs[i + 1], state, stop,
                                          beats[i]),
                                    daemon=True)
                   for i, st in enumerate(self.stages)]
        for t in threads:
            t.start()

        def feed() -> None:
            try:
                it = iter(items)
                while True:
                    if stop.is_set():
                        break       # a stage died: consume no more payloads
                    # a wedged payload source is diagnosable too
                    feed_hb["since"] = time.perf_counter()
                    feed_hb["busy"] = True
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    finally:
                        feed_hb["busy"] = False
                    feed_hb["done"] += 1
                    qs[0].put(item)
            except BaseException as e:  # the payload source failed
                state["error"] = e
                stop.set()
            finally:
                qs[0].put(_SENTINEL)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        wd = self.watchdog_seconds
        poll = min(0.2, wd / 5.0) if wd > 0 else None
        while True:
            with trace.span("pipeline.wait"):
                item = self._next_out(qs, poll, beats + [feed_hb], stop)
            if item is _SENTINEL:
                break
            yield item
        feeder.join()
        for t in threads:
            t.join()
        if state["error"] is not None:
            self._error = state["error"]
            raise state["error"]
