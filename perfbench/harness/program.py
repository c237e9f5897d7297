"""The program's own spans and counters over a traced stretch.

The port records spans (``repro_torch.trace``) only while the profiler
records, so the traced stretch's ``run.trace.steps`` train steps are the
last that many ``lm.train_step`` spans the process holds, however many
runs it made; a span belongs to a step when it carries that step's
ordinal (a span opened between steps carries the next step's).  A
program without the recorder, or a run without a trace, gives None, and
each reader then reports nothing.

Each span metric sums a step's spans (microbatches included) and reports
the median over the traced steps.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional, Tuple

from .trace import gaps

TRAIN_STEP = "lm.train_step"
ANCHOR_SPREAD_S = 1e-4    # how far the clock offset may be unsure


@dataclasses.dataclass
class Step:
    top: Dict[str, Any]             # the step's own lm.train_step entry
    spans: List[Dict[str, Any]]     # every other entry with its ordinal

    def named(self, name: str) -> List[Dict[str, Any]]:
        return [e for e in self.spans if e["name"] == name]

    def device_ms(self, name: str) -> float:
        return sum(e["device_ms"] for e in self.named(name))


def steps(run) -> Optional[List[Step]]:
    """The traced stretch's steps in order, or None."""
    if run.trace is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    entries = trace.spans()
    tops = [e for e in entries if e["name"] == TRAIN_STEP]
    n = run.trace.steps
    if n < 1 or len(tops) < n:
        return None
    tops = tops[-n:]
    mine: Dict[int, List[Dict[str, Any]]] = {t["step"]: [] for t in tops}
    for e in entries:
        if e["name"] != TRAIN_STEP and e["step"] in mine:
            mine[e["step"]].append(e)
    return [Step(t, mine[t["step"]]) for t in tops]


def span_ms(run, name: str) -> Optional[float]:
    """The median over traced steps of the device ms of ``name``'s spans
    in a step; None where no traced step has one."""
    got = steps(run)
    if not got or not any(s.named(name) for s in got):
        return None
    return float(statistics.median(s.device_ms(name) for s in got))


def anchors(run) -> Optional[Tuple[List[float], List[float]]]:
    """Bounds on the seconds to add to ``perf_counter`` to be on the
    trace's clock.  The benchmark's ``pb.step`` annotation wraps exactly
    one train step and its ``pb.input_wait`` that step's wait for its
    batch, so each pair gives a lower bound (the annotation's start less
    the span's) and an upper one (the annotation's end less the span's):
    ``(lows, highs)``, or None where the pairs do not line up."""
    got = steps(run)
    if not got:
        return None
    lows, highs = [], []
    for name, inner in (("step", lambda s: s.top),
                        ("input_wait",
                         lambda s: (s.named("pipeline.wait") or [None])[0])):
        outer = [a for a in run.trace.spans if a.name == name]
        spans = [inner(s) for s in got]
        if len(outer) != len(spans) or None in spans:
            return None
        lows += [a.start - e["start_ns"] * 1e-9 for a, e in zip(outer, spans)]
        highs += [a.end - e["end_ns"] * 1e-9 for a, e in zip(outer, spans)]
    return lows, highs


def clock_offset(run) -> Optional[float]:
    """The offset every anchor allows (the middle of the interval between
    the largest lower bound and the smallest upper one), or None where the
    anchors contradict one another or leave the offset less sure than
    ``ANCHOR_SPREAD_S`` either way.  Host jitter only loosens a bound, so
    the tightest pair of anchors decides."""
    bounds = anchors(run)
    if bounds is None:
        return None
    lo, hi = max(bounds[0]), min(bounds[1])
    if hi < lo or hi - lo > 2 * ANCHOR_SPREAD_S:
        return None
    return 0.5 * (lo + hi)


def idle_share(run, name: str) -> Optional[float]:
    """Median over traced steps of the share, in %, of ``name``'s host
    intervals in a step (on the trace's clock) in which the card was
    idle."""
    got, off = steps(run), clock_offset(run)
    if not got or off is None:
        return None
    idle = gaps(run.trace)
    shares = []
    for s in got:
        spans = [(e["start_ns"] * 1e-9 + off, e["end_ns"] * 1e-9 + off)
                 for e in s.named(name)]
        total = sum(b - a for a, b in spans)
        if total <= 0:
            return None
        hit = sum(max(0.0, min(b, hi) - max(a, lo))
                  for a, b in spans for lo, hi in idle)
        shares.append(100.0 * hit / total)
    return float(statistics.median(shares))
