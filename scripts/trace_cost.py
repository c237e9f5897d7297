"""What the span recorder (``repro_torch.trace``) costs, on and off.

    PYTHONPATH=src python3 scripts/trace_cost.py [--n 20000] [--repeats 5]
        [--device cuda] [--spans-per-step 150]

Times ``--n`` turns of an empty loop on the host clock, ``--repeats``
times, and reports the median nanoseconds a turn for:

* ``bare``: the loop alone, no profiler;
* ``off``: a span each turn, no profiler (the recorder's one check);
* ``range``: under ``torch.profiler`` (CPU and, on a card, CUDA
  activity), inside one train step's span on ``--device``, a bare
  ``record_function`` range each turn;
* ``on``: the same with a span each turn (the range, the entry and, on a
  card, its pair of CUDA events).

Prints one JSON line: those, ``off - bare`` and ``on - range`` a span,
and both times ``--spans-per-step`` (the spans of one train step of the
benchmark's cell: 48 layers run twice under remat, 48 attention VJPs, six
more), with the device's name and, on a card, its power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace


def _loop(n: int, body) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        body()
    return (time.perf_counter_ns() - t0) / n


def _bare() -> None:
    pass


def _off() -> None:
    with trace.span("cost"):
        pass


def _range() -> None:
    with torch.profiler.record_function("cost"):
        pass


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spans-per-step", type=int, default=150)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ns = {k: [] for k in ("bare", "off", "range", "on")}
    for _ in range(args.repeats):
        ns["bare"].append(_loop(args.n, _bare))
        ns["off"].append(_loop(args.n, _off))
        with profile(activities=acts):
            with trace.step(dev):
                ns["range"].append(_loop(args.n, _range))
                ns["on"].append(_loop(args.n, _off))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        kept = sum(1 for e in trace.spans() if e["name"] == "cost")
        if kept != args.n:
            raise RuntimeError(f"recorded {kept} spans of {args.n}")
        trace.reset()
    med = {k: statistics.median(v) for k, v in ns.items()}
    off, on = med["off"] - med["bare"], med["on"] - med["range"]
    out = {"ns_a_turn": med, "off_ns_a_span": off, "on_ns_a_span": on,
           "off_us_a_step": off * args.spans_per_step / 1e3,
           "on_us_a_step": on * args.spans_per_step / 1e3,
           "range_us_a_step": med["range"] * args.spans_per_step / 1e3,
           "n": args.n, "repeats": args.repeats,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "power_limit": _power_limit() if dev.type == "cuda" else "none"}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
