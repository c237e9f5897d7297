"""The comparison that decides ``correct`` for a training cell.

The program's first steps are held against the plain reference's on the
same weights and batches:

* ``loss_gap``: the relative gap of the first step's loss (a forward on
  the start weights);
* ``loss_gap_steps``: the widest relative gap of a step's loss over the
  compared steps; after AdamW's first step every weight has moved by
  about the learning rate, the loss leaps and the later steps amplify
  rounding, so this reading is reported and a cell
  compares it only where it separates sound runs from the control;
* ``grad_gap``: the first gradient as the optimizer got it, leaf by leaf:
  the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; the worst leaf;
* ``grad_gap_median``: the same gap's median over the leaves, steady
  where one small leaf's gap swings from seed to seed;
* ``change_gap``: the same for the parameters' change over the compared
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
* ``batch_mismatch``: compared batches of the program's pipeline that
  differ from the benchmark's own, bit for bit;
* ``nonfinite``: steps of the window whose loss is not finite.

Each number has its cell's limit (``perfbench/limits/<workload>.json``);
the run is correct when every number is finite and within it.  A limit of
``null`` marks a number the cell does not compare (no control or fault
separates it from sound runs there); it is still reported.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

NUMBERS = ("loss_gap", "loss_gap_steps", "grad_gap", "grad_gap_median",
           "change_gap", "batch_mismatch", "nonfinite")
QUIET_LEAF = 1e-3


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's ``|prog - ref| / max(ref, median ref)``."""
    med = statistics.median(ref[k] for k in leaves)
    gaps = {}
    for k in leaves:
        den = max(ref[k], med)
        gaps[k] = abs(prog[k] - ref[k]) / den if den > 0 else \
            (0.0 if prog[k] == 0 else math.inf)
    return gaps


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap (a NaN is the worst) and its name."""
    worst, at = 0.0, ""
    for k, gap in leaf_gaps(prog, ref, leaves).items():
        if not gap <= worst:
            worst, at = gap, k
    return worst, at


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient reaches a thousandth of the median
    leaf's."""
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= QUIET_LEAF * med]


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``losses`` (compared steps), ``grad``
    (``{leaf: first gradient norm}``) and ``change`` (``{leaf: change
    norm}``); ``prog`` also ``batch_mismatch`` and ``nonfinite``."""
    leaves = sorted(ref["grad"])
    grad, grad_at = leaf_gap(prog["grad"], ref["grad"], leaves)
    grad_median = statistics.median(
        leaf_gaps(prog["grad"], ref["grad"], leaves).values())
    change, change_at = leaf_gap(prog["change"], ref["change"],
                                 moving_leaves(ref["grad"]))
    return {"loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "loss_gap_steps": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": grad, "grad_gap_median": grad_median,
            "change_gap": change,
            "batch_mismatch": float(prog["batch_mismatch"]),
            "nonfinite": float(prog["nonfinite"]),
            "_grad_leaf": grad_at, "_change_leaf": change_at}


def verdict(nums: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(c["limit"] is None
             or (math.isfinite(c["value"]) and c["value"] <= c["limit"])
             for c in checks.values())
    return ok, checks
