"""Readings that a cross-card cell's correctness limits are set from, at
the cell's own size (``control.py``'s modes for the ``lm_train_mesh``
driver).

    python3 perfbench/control_mesh.py --workload <cell> --seeds 1,2,3 \\
        --mode program|control|state_unchanged|half_batch

``program``: sound runs of the program (a window of two steps, then the
usual comparison).  ``control``: the plain reference computed in fp8
(``reference.moe``'s ``precision="fp8"``) in the program's place, against
the f32 reference.  ``state_unchanged``, ``half_batch``: the program with
that fault planted underneath its timed path.  Prints one JSON line a seed
with the compared numbers, and last the largest of each over the seeds.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.harness import judge, spec  # noqa: E402
from perfbench.run import environment  # noqa: E402

MODES = ("program", "control", "state_unchanged", "half_batch")


def readings(cell, seed: int, mode: str, device=None) -> dict:
    """The compared numbers of one seed in ``mode``."""
    from perfbench.drivers import lm_train_mesh
    fault = mode if mode in lm_train_mesh.FAULTS else None
    return lm_train_mesh.run(
        cell, seed, 0.0, False, started=time.time(), fault=fault,
        device=device,
        mode="control" if mode == "control" else "program")["numbers"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    args = ap.parse_args(argv)
    environment()
    cell = spec.cell(args.workload)
    worst: dict = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = readings(cell, seed, args.mode)
        print(json.dumps({"mode": args.mode, "seed": seed, **nums}),
              flush=True)
        for k in judge.NUMBERS:
            worst[k] = max(worst.get(k, 0.0), nums[k])
    print(json.dumps({"mode": args.mode, "workload": args.workload,
                      "max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
