"""Two-stage feature prefetching / pipelined runtime (paper Section IV-B).

Port of ``repro/core/pipeline.py`` (without the stall watchdog and the
fault-injection hooks, which are not ported yet).  Each stage runs in its
own host thread and hands items on through ``queue.Queue(maxsize=depth)``:
with the paper's default depth 2 the Feature Loader works on mini-batch
i+2 while the Data Transfer stage ships i+1 and the trainers execute i
(paper Fig. 7).  ``depth=0`` runs the stages one after another — the
ablation baseline of Fig. 11.

Every item carries a ``timings`` dict with each stage's service time and,
when pipelined, ``<stage>_wait``: how long the stage sat starved on its
input queue.  A stage that raises stops the feeder, every worker drains to
its sentinel, and ``run()`` re-raises.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

__all__ = ["PipelineItem", "Stage", "PrefetchPipeline"]

_SENTINEL = object()


@dataclasses.dataclass
class PipelineItem:
    seq: int
    payload: Any
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Stage:
    name: str
    fn: Callable[[PipelineItem], PipelineItem]   # mutates/returns the item


class PrefetchPipeline:
    """Chains stages over bounded queues; ``depth=0`` means sequential.

    Every ``run()`` threads its own queues, error holder and stop event
    through the workers it spawns; all cross-thread handoffs ride the
    queues, whose put/get pairs order them, so the class has no shared
    state to guard."""

    def __init__(self, stages: List[Stage], depth: int = 2):
        self.stages = stages
        self.depth = int(depth)

    def _run_sequential(self, items: Iterable[PipelineItem]
                        ) -> Iterator[PipelineItem]:
        for item in items:
            for st in self.stages:
                t0 = time.perf_counter()
                item = st.fn(item)
                item.timings[st.name] = time.perf_counter() - t0
            yield item

    def _worker(self, st: Stage, q_in: "queue.Queue", q_out: "queue.Queue",
                state: Dict[str, Optional[BaseException]],
                stop: threading.Event) -> None:
        failed = False
        while True:
            t_wait = time.perf_counter()
            item = q_in.get()
            wait = time.perf_counter() - t_wait
            if item is _SENTINEL:
                q_out.put(_SENTINEL)
                return
            if failed or stop.is_set():
                continue            # drain so the feeder never blocks
            try:
                item.timings[st.name + "_wait"] = wait
                t0 = time.perf_counter()
                item = st.fn(item)
                item.timings[st.name] = time.perf_counter() - t0
            except BaseException as e:  # handed to the consumer, re-raised
                state["error"] = e
                stop.set()
                failed = True
                continue
            q_out.put(item)

    def run(self, items: Iterable[PipelineItem]) -> Iterator[PipelineItem]:
        if self.depth <= 0:
            yield from self._run_sequential(items)
            return
        state: Dict[str, Optional[BaseException]] = {"error": None}
        stop = threading.Event()
        qs: List["queue.Queue"] = [queue.Queue(maxsize=self.depth)
                                   for _ in range(len(self.stages) + 1)]
        threads = [threading.Thread(target=self._worker,
                                    args=(st, qs[i], qs[i + 1], state, stop),
                                    daemon=True)
                   for i, st in enumerate(self.stages)]
        for t in threads:
            t.start()

        def feed() -> None:
            try:
                for item in items:
                    if stop.is_set():
                        break       # a stage died: consume no more payloads
                    qs[0].put(item)
            except BaseException as e:  # the payload source failed
                state["error"] = e
                stop.set()
            finally:
                qs[0].put(_SENTINEL)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        while True:
            item = qs[-1].get()
            if item is _SENTINEL:
                break
            yield item
        feeder.join()
        for t in threads:
            t.join()
        if state["error"] is not None:
            raise state["error"]
