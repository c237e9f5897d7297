"""Readings that the correctness limits are set from, at a cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --mode program|control|state_unchanged|half_batch|ref_half_batch

``program``: sound runs of the program (a short window, then the usual
comparison).  ``control``: the plain reference in the program's place,
computed in fp8 (``reference.lm``'s ``precision="fp8"``), against the f32
reference.  ``state_unchanged``, ``half_batch``: the program with that
fault planted underneath its timed path.  ``ref_half_batch``: the fault
planted in the f32 reference put in the program's place.  Prints one JSON
line a seed with the compared numbers, and last the largest of each over
the seeds.  The benchmark's own runs never run this.
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

MODES = ("program", "control", "state_unchanged", "half_batch",
         "ref_half_batch")


def readings(cell, seed: int, mode: str, device=None) -> dict:
    """The compared numbers of one seed in ``mode``.  ``control`` and
    ``ref_half_batch`` put the reference in the program's place, over the
    whole batch in fp8 or over its first half in f32, against the f32
    reference over the whole."""
    from perfbench.drivers import lm_train
    if mode in ("control", "ref_half_batch"):
        import torch
        dev = (torch.device("cpu") if device == "cpu"
               else torch.device("cuda", 0))
        if mode == "control":
            prog = lm_train.reference(cell, seed, dev, precision="fp8")
        else:
            prog = lm_train.reference(cell, seed, dev,
                                      keep=cell["traffic"]["batch"] // 2)
        prog.update(batch_mismatch=0, nonfinite=0)
        return judge.numbers(prog, lm_train.reference(cell, seed, dev))
    fault = None if mode == "program" else mode
    return lm_train.run(cell, seed, 0.0, False, started=time.time(),
                        fault=fault, device=device)["numbers"]


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
