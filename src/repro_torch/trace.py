"""Spans and counters at the layer boundaries of the port's train step.

A span records only while ``torch.profiler`` records on the calling
thread (``torch.autograd._profiler_enabled()``, which autograd carries
into its worker thread, where the remat recompute and the attention VJP
run).  Otherwise ``span`` is that one check and a shared no-op: no event,
no lock, no allocation.  So a profiled run gets the program's phases and
an unprofiled one pays nothing, with no flag to set.

When on, a span enters ``torch.profiler.record_function(name)``, so the
profiler's own trace shows it on its clock beside the kernels it
launched, and keeps one entry: its name, host thread, parent (the
innermost open span on that thread), step ordinal, host start and end
(``time.perf_counter_ns``) and, inside a train step on a CUDA device, a
pair of timing events recorded on the thread's current stream.  The step
runs on one stream, so the pair brackets exactly the work the span
queued; its device interval is the stream's time through that work,
waits for the host included.

The step ordinal is that of the innermost open ``lm.train_step``
(``step``), shared with autograd's thread; a span opened outside every
step takes the ordinal the next step will have.  Entries live in memory,
the newest ``CAPACITY`` of them (older ones are dropped and counted);
``spans()`` and ``summary()`` read them, after the caller has
synchronized the device.  One train step is open at a time.

    from repro_torch import trace
    with trace.span("lm.forward"):
        ...
    trace.count("alloc_retries", n)      # onto the innermost open span
"""
from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.annotations import guarded_by

__all__ = ["span", "step", "count", "spans", "reset", "summary", "dropped",
           "CAPACITY", "TRAIN_STEP"]

CAPACITY = 65_536
TRAIN_STEP = "lm.train_step"

_profiler_enabled = torch.autograd._profiler_enabled


def _decorate(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return traced


class _Off:
    """The shared no-op of one span name: a context, and a decorator whose
    calls each decide anew whether to record."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn: Callable) -> Callable:
        return _decorate(self.name, fn)


_OFF: Dict[str, _Off] = {}


def _off(name: str) -> _Off:
    off = _OFF.get(name)
    return off if off is not None else _OFF.setdefault(name, _Off(name))


class _Span:
    """One recorded span (the profiler is on)."""
    __slots__ = ("name", "device", "id", "parent", "step", "thread",
                 "t0", "t1", "events", "counters", "_stream", "_retries",
                 "_rf")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        self.name = name
        self.device = device          # set for a step; else its step's
        self.events = None
        self.counters: Dict[str, int] = {}
        self._retries = None

    def __call__(self, fn: Callable) -> Callable:
        return _decorate(self.name, fn)

    def __enter__(self) -> "_Span":
        # the host interval holds the profiler's own range, so the two
        # agree but for the range's cost outside its timestamps
        self.t0 = time.perf_counter_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        stack = _REC.stack()
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        _REC.open(self)
        dev = self.device
        if dev is not None and dev.type == "cuda":
            self._stream = torch.cuda.current_stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self._stream)
            if self.name == TRAIN_STEP:
                self._retries = _alloc_retries(dev)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _REC.stack().pop()
        if self.events is not None:
            self.events[1].record(self._stream)
        if self._retries is not None:
            self.counters["alloc_retries"] = \
                _alloc_retries(self.device) - self._retries
        elif self.name == TRAIN_STEP:
            self.counters["alloc_retries"] = 0
        self._rf.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        self._rf = self._stream = None      # a kept entry holds its events
        _REC.close(self)
        return False

    def entry(self) -> Dict[str, Any]:
        host_ms = (self.t1 - self.t0) * 1e-6
        device_ms = (self.events[0].elapsed_time(self.events[1])
                     if self.events is not None else host_ms)
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "step": self.step, "thread": self.thread,
                "start_ns": self.t0, "end_ns": self.t1, "host_ms": host_ms,
                "device_ms": device_ms, "counters": dict(self.counters)}


def _alloc_retries(dev: torch.device) -> int:
    """Times the caching allocator freed its cache and synchronized to
    retry an allocation on ``dev``."""
    return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)


@guarded_by("_lock", "_done", "_dropped", "_open_steps", "_next_step",
            "_next_id")
class _Recorder:
    """The spans of the process: the closed ones, the open steps (which
    autograd's thread reads) and the ordinals.  Each thread's stack of
    open spans is its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done: "collections.deque[_Span]" = collections.deque(
            maxlen=CAPACITY)
        self._dropped = 0
        self._open_steps: List[_Span] = []
        self._next_step = 0
        self._next_id = 0
        self._local = threading.local()

    def stack(self) -> List[_Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, sp: _Span) -> None:
        with self._lock:
            sp.id = self._next_id
            self._next_id += 1
            if sp.name == TRAIN_STEP:
                sp.step = self._next_step
                self._next_step += 1
                self._open_steps.append(sp)
            elif self._open_steps:
                sp.step = self._open_steps[-1].step
                sp.device = self._open_steps[-1].device
            else:
                sp.step = self._next_step

    def close(self, sp: _Span) -> None:
        with self._lock:
            if sp.name == TRAIN_STEP:
                self._open_steps.remove(sp)
            if len(self._done) == CAPACITY:
                self._dropped += 1
            self._done.append(sp)

    def closed(self) -> List[_Span]:
        with self._lock:
            return list(self._done)

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._done.clear()
            self._dropped = 0


_REC = _Recorder()


def span(name: str):
    """A context (and decorator) that records ``name`` while the profiler
    records on this thread, and is a shared no-op otherwise."""
    if not _profiler_enabled():
        return _off(name)
    return _Span(name)


def step(device) -> Any:
    """The span of one train step on ``device`` (``TRAIN_STEP``): it
    numbers the step, gives the spans inside it its device, and counts
    ``alloc_retries``, the caching allocator's retries over it (0 on the
    host)."""
    if not _profiler_enabled():
        return _off(TRAIN_STEP)
    return _Span(TRAIN_STEP, torch.device(device))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost span open on this
    thread (nothing while the profiler is off, or outside every span)."""
    if not _profiler_enabled():
        return
    stack = _REC.stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n


def spans() -> List[Dict[str, Any]]:
    """The kept entries in order of their start, device milliseconds
    resolved (synchronize the device first): ``id``, ``name``, ``parent``
    (an id or None), ``step``, ``thread``, ``start_ns`` / ``end_ns``
    (``perf_counter_ns``), ``host_ms``, ``device_ms`` (``host_ms`` where
    the span had no CUDA device) and ``counters``."""
    return sorted((s.entry() for s in _REC.closed()),
                  key=lambda e: (e["start_ns"], e["id"]))


def dropped() -> int:
    """Entries dropped since the last ``reset()`` to keep ``CAPACITY``."""
    return _REC.dropped()


def reset() -> None:
    """Forget the kept entries and the count of dropped ones."""
    _REC.reset()


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``host_ms`` and ``device_ms`` summed, and
    each counter summed (synchronize the device first)."""
    out: Dict[str, Dict[str, float]] = {}
    for e in spans():
        s = out.setdefault(e["name"], {"count": 0, "host_ms": 0.0,
                                       "device_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += e["host_ms"]
        s["device_ms"] += e["device_ms"]
        for k, v in e["counters"].items():
            s[k] = s.get(k, 0) + v
    return out
