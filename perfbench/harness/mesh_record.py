"""What one run across cards measured, as the metric readers see it: a
``record.Run`` (rank 0's, with the fullest card's memory peak) plus the
rank count and the MoE counters of the traced steps summed over the
ranks."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from . import program
from .record import Run

MOE_COUNTERS = ("moe.assignments", "moe.dropped", "moe.slots",
                "moe.slots_filled")


@dataclasses.dataclass
class MeshRun(Run):
    ranks: int = 1
    # the traced steps' forward MoE counters, summed over the ranks
    moe_counters: Optional[Dict[str, int]] = None


def _in_backward(step: program.Step, entry) -> bool:
    return any(b["start_ns"] <= entry["start_ns"]
               and entry["end_ns"] <= b["end_ns"]
               for b in step.named("lm.backward"))


def forward_counts(run) -> Optional[Dict[str, int]]:
    """This process's MoE counters over the traced steps' forwards (the
    remat recompute inside ``lm.backward`` routes the same tokens again
    and is left out), or None where the program counts none."""
    got = program.steps(run)
    if not got:
        return None
    out = {k: 0 for k in MOE_COUNTERS}
    seen = False
    for step in got:
        for e in step.spans:
            if not set(MOE_COUNTERS) & set(e["counters"]) or \
                    _in_backward(step, e):
                continue
            seen = True
            for k in MOE_COUNTERS:
                out[k] += e["counters"].get(k, 0)
    return out if seen else None
