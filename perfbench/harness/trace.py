"""The device trace of a traced stretch.

The benchmark annotates its own calls into the program (``pb.input_wait``
around the pipeline's ``next()``, ``pb.step`` around the train step,
``pb.window_end`` around the last synchronize) with ``record_function``,
so the profiler's trace puts them on the clock of the card's kernels.
The trace is read from ``torch.profiler``'s chrome export: kernels, copies
and sets on the device, and those annotations on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "pb."


@dataclasses.dataclass
class Event:
    name: str
    start: float     # seconds on the trace's clock
    end: float
    cat: str


@dataclasses.dataclass
class Trace:
    device: List[Event]        # kernels, copies and sets on the card
    spans: List[Event]         # the benchmark's annotations
    start: float
    end: float
    steps: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self) -> List[Event]:
        return [e for e in self.device if e.cat == "kernel"]


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A host interval under ``pb.<name>`` in the profiler's trace."""
    with torch.profiler.record_function(PREFIX + name):
        yield


def profile(body: Callable[[], int]) -> Trace:
    """Run ``body`` (which returns the number of steps it ran) under the
    profiler and read the trace back.  The traced window runs from the
    first benchmark annotation's start to the last one's end."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        steps = body()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    device, spans = [], []
    for e in raw.get("traceEvents", []):
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if cat in DEVICE_CATS:
            device.append(Event(e["name"], e["ts"] * 1e-6,
                                (e["ts"] + e["dur"]) * 1e-6, cat))
        elif cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append(Event(e["name"][len(PREFIX):], e["ts"] * 1e-6,
                               (e["ts"] + e["dur"]) * 1e-6, cat))
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    device.sort(key=lambda e: e.start)
    spans.sort(key=lambda e: e.start)
    return Trace(device, spans, spans[0].start,
                 max(s.end for s in spans), steps)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(tr: Trace, events: Optional[List[Event]] = None) -> float:
    """Seconds of the traced window in which some device operation ran."""
    evs = tr.device if events is None else events
    return sum(b - a for a, b in clip(union([(e.start, e.end) for e in evs]),
                                      tr.start, tr.end))


def gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The traced window's intervals with nothing on the device."""
    out, t = [], tr.start
    for a, b in clip(union([(e.start, e.end) for e in tr.device]),
                     tr.start, tr.end):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if tr.end > t:
        out.append((t, tr.end))
    return out


def _span_at(tr: Trace, t: float) -> str:
    """The innermost benchmark span open on the host at ``t``."""
    best = None
    for s in tr.spans:
        if s.start <= t < s.end and (best is None or s.start >= best.start):
            best = s
    return best.name if best is not None else "between_spans"


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps named after the benchmark span the host was in when each began."""
    by_name: Dict[str, float] = {}
    for e in tr.device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:96], s] for n, s in ops],
            "idle_gaps": [[_span_at(tr, a), b - a] for a, b in idle]}
