"""The port's static analyzer (the ``RPT`` rule set).

The counterpart of ``repro.analysis`` for ``src/repro_torch``: its lock,
determinism and kernel rules, fitted to torch and to the Hopper kernels.
Run with ``python -m repro_torch.analysis src/repro_torch``; the rule
catalog and the suppression conventions are in
docs/static-analysis-torch.md.  Importing it imports no torch.

Families:

* ``RPT000`` — unused ``# noqa`` suppression (meta-rule); ``RPT999`` —
  syntax error.
* ``RPT1xx`` — lock discipline over ``guarded_by`` annotations, with
  torch's host-blocking calls (:mod:`repro_torch.analysis.rules_locks`).
* ``RPT2xx`` — kernel invariants over ``kernels/csrc`` and the wrappers
  in ``kernels/ops.py``, and the no-fallback rule
  (:mod:`repro_torch.analysis.rules_kernels`).
* ``RPT3xx`` — determinism & accounting, with torch's global RNG
  (:mod:`repro_torch.analysis.rules_determinism` + RPT303 in
  rules_locks).
"""
from ..annotations import guarded_by, requires_lock
from .engine import Engine, Finding, Rule, default_rules, main, run_paths

__all__ = ["Engine", "Finding", "Rule", "default_rules", "main",
           "run_paths", "guarded_by", "requires_lock"]
