"""Where a traced train step of a benchmark cell goes, by program span.

    python3 scripts/span_breakdown.py [--workload musicgen-medium.clips-30s]
        [--seed N] [--seconds 10] [--out DIR]

Runs the cell once through its ``perfbench/drivers/`` module with the
traced stretch on, then reads the port's own spans (``repro_torch.trace``) of
the traced steps: for each span name its spans a step, device and host
ms a step (medians over the steps), and the share of its host intervals,
placed on the trace's clock, in which the card sat idle; the bounds the
anchors put on that clock's offset (``pb.step`` against
``lm.train_step``, ``pb.input_wait`` against ``pipeline.wait``; in
microseconds above the largest lower bound); the allocator's retries a
step; the trace's copies by kind (count, ms, the longest); and the
cell's per-layer metrics.  Prints one JSON line (also to
``DIR/span_breakdown.json`` with ``--out``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.harness import program, spec  # noqa: E402


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def breakdown(run) -> dict:
    steps = program.steps(run)
    if not steps:
        raise RuntimeError("the run holds no program spans")
    names = sorted({e["name"] for s in steps for e in s.spans}
                   | {program.TRAIN_STEP})
    spans = {}
    for name in names:
        def pick(s, name=name):
            return [s.top] if name == program.TRAIN_STEP else s.named(name)
        spans[name] = {
            "a_step": statistics.median(len(pick(s)) for s in steps),
            "device_ms": statistics.median(
                sum(e["device_ms"] for e in pick(s)) for s in steps),
            "host_ms": statistics.median(
                sum(e["host_ms"] for e in pick(s)) for s in steps),
            "idle_pct": (program.idle_share(run, name)
                         if name != program.TRAIN_STEP else None)}
    lows, highs = program.anchors(run)
    lo = max(lows)
    copies: dict = {}
    for e in run.trace.device:
        if e.cat == "gpu_memcpy":
            c = copies.setdefault(e.name, {"count": 0, "ms": 0.0,
                                           "max_ms": 0.0})
            c["count"] += 1
            c["ms"] += 1e3 * (e.end - e.start)
            c["max_ms"] = max(c["max_ms"], 1e3 * (e.end - e.start))
    return {
        "spans": spans,
        "anchors_us": {"lows": [(x - lo) * 1e6 for x in lows],
                       "highs": [(x - lo) * 1e6 for x in highs],
                       "width": (min(highs) - lo) * 1e6},
        "alloc_retries": [s.top["counters"].get("alloc_retries")
                          for s in steps],
        "memcpy": copies,
        "traced_steps": len(steps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="musicgen-medium.clips-30s")
    ap.add_argument("--seed", type=int, default=2**31 + 31)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    captured = {}
    read = spec.read_metrics

    def keep(entries, run, root=spec.ROOT):
        if run.trace is not None:
            captured["run"] = run
        return read(entries, run, root)
    spec.read_metrics = keep
    drv = spec.driver(cell["traffic"]["driver"])
    rec = drv.run(cell, args.seed, args.seconds, True, started=time.time())
    out = breakdown(captured["run"])
    out.update(workload=args.workload, seed=args.seed,
               per_layer=rec["per_layer"], card=_power_limit(),
               step_ms_window_median=statistics.median(rec["step_ms"]))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "span_breakdown.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
