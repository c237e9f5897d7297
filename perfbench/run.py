"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the cards of this machine and
prints, as its last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (window steps, and those whose loss was not
finite), ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), ``device`` and, traced,
``breakdown``; last, ``checks``: each number compared with its limit.  The
same checks end standard error.

Exits 2 without a result where CUDA is absent or the cell asks for more
cards than are visible, and 3 where a JAX module was loaded.  Build and
kernel caches stay under ``build/`` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

_IMPORTED = time.time()
ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.harness import imports, judge, spec  # noqa: E402


def process_start() -> float:
    """Wall time at which this process started (its ``/proc`` start time;
    the module's import where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


def environment() -> None:
    """Kernel caches in fixed directories inside the checkout."""
    cache = ROOT / "build" / "perfbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "unknown"


def measure(cell, seed: int, seconds: float, traced: bool, started: float,
            device=None, fault=None):
    """One run of ``cell`` past the look for cards: the result line's
    object, or None (with the names on standard error) where a JAX module
    was loaded.  ``device="cpu"`` and ``fault`` serve the harness's own
    tests."""
    drv = spec.driver(cell["traffic"]["driver"])
    rec = drv.run(cell, seed, seconds, traced, started=started,
                  fault=fault, device=device)
    loaded = imports.forbidden()
    if loaded:
        print(f"perfbench: JAX modules loaded: {loaded}", file=sys.stderr)
        return None
    if traced:
        metrics = rec["per_layer"]
    else:
        metrics = spec.read_metrics(cell["end_to_end"], drv.as_run(cell, rec))
    ok, checks = judge.verdict(rec["numbers"], cell["limits"])
    dev = {"platform": "gpu" if device is None else device,
           "kind": rec["device_kind"], "count": rec["cards"],
           "memory_peak_bytes": rec["peak_bytes"],
           "power_limit": _power_limit() if device is None else "none"}
    result = {"correct": ok, "attempted": rec["steps"],
              "failed": rec["nonfinite"], "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["traced_window_s"]
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    readings = rec["readings"]
    print(f"setup phases (s from process start) and window allocator "
          f"retries: {rec['phases']}",
          file=sys.stderr)
    print(f"losses: program {readings['program']['losses']} reference "
          f"{readings['reference']['losses']}; worst leaves: grad "
          f"{rec['numbers']['_grad_leaf']}, change "
          f"{rec['numbers']['_change_leaf']}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    cell = spec.cell(args.workload)
    chips = cell["workload"]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace),
                     started)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
