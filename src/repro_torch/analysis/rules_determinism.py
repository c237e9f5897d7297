"""RPT3xx determinism & accounting rules.

The port's counterpart of ``repro/analysis/rules_determinism.py``.

* **RPT301** — a draw from, or a seeding of, a global RNG.  The port's
  determinism contract is explicit generators everywhere: seeded
  ``np.random.default_rng``/``Generator`` instances on the host and
  ``torch.Generator`` objects passed as ``generator=`` to every torch
  draw (the accelerator sampler's per-hop ``randint``, the weight
  initialisers).  Global-state draws make results depend on import order,
  thread interleaving and whatever else drew before.  It fires on:

  - the reference's case, a bare ``np.random.*`` call (``seed``,
    ``randint``, ``shuffle``, ...) other than the generator constructors;
  - ``torch.manual_seed``, ``torch.seed``, ``torch.random.manual_seed``
    and ``torch.cuda.manual_seed`` / ``manual_seed_all`` (a
    ``torch.Generator(...).manual_seed(s)`` seeds its own generator and
    is fine);
  - ``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
    ``multinomial``/``normal`` and their ``*_like`` forms, and the
    in-place ``Tensor`` draws (``random_``, ``uniform_``, ``normal_``,
    ``bernoulli_``, ``exponential_``, ``cauchy_``, ``geometric_``,
    ``log_normal_``) called without a ``generator=`` keyword.  A
    ``*_like`` draw takes no generator in torch, so it always fires.
    Edge: ``torch.nn.init``'s in-place draws are matched by name alike.

* **RPT302** — an ``except:`` / ``except BaseException:`` handler that
  can swallow ``WorkerKilled`` (``repro_torch/graph/faults.py``).  Kill
  faults derive from ``BaseException`` *on purpose* so that ordinary
  ``except Exception`` resilience code passes them through; a handler
  broad enough to catch them must re-raise or record the bound exception
  (``except BaseException as e: ... e ...``): silently dropping it turns
  an injected worker death into a hang.
* **RPT303** — counter accounting under the declared guard; emitted by
  the lock-discipline state machine (see ``rules_locks``), documented
  here with its family.

``except Exception`` is deliberately *not* flagged: it cannot catch
``WorkerKilled`` and is the recommended resilience idiom.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional

from .engine import FileContext, Rule

__all__ = ["DeterminismRules"]

_ALLOWED_NP_RANDOM = {"default_rng", "Generator", "SeedSequence",
                      "PCG64", "Philox", "MT19937", "BitGenerator"}
#: receivers of a global torch seeding call
_TORCH_SEED_MODULES = {"torch", "torch.random", "torch.cuda"}
_TORCH_SEEDS = {"manual_seed", "manual_seed_all", "seed", "seed_all"}
#: ``torch.<draw>(...)`` functions that take ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli",
                "multinomial", "normal", "poisson"}
#: ``torch.<draw>(...)`` functions that take no generator at all
_TORCH_LIKE_DRAWS = {"rand_like", "randn_like", "randint_like"}
#: in-place ``Tensor`` draws, any receiver
_TENSOR_DRAWS = {"random_", "uniform_", "normal_", "bernoulli_",
                 "exponential_", "cauchy_", "geometric_", "log_normal_"}


def _is_broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id == "BaseException"
    if isinstance(t, ast.Attribute):
        return t.attr == "BaseException"
    if isinstance(t, ast.Tuple):
        return any(_is_broad_handler(
            ast.ExceptHandler(type=e, name=None, body=[])) for e in t.elts)
    return False


def _dotted(expr: ast.expr) -> Optional[str]:
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


@dataclasses.dataclass
class _Handler:
    node: ast.ExceptHandler
    bound: Optional[str]
    saved: bool = False


class DeterminismRules(Rule):
    types = (ast.Call, ast.ExceptHandler, ast.Raise, ast.Name)

    def __init__(self) -> None:
        self._handlers: List[_Handler] = []

    def begin_file(self, ctx: FileContext) -> None:
        self._handlers = []

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Call):
            self._check_np_random(node, ctx)
            self._check_torch_random(node, ctx)
        elif isinstance(node, ast.ExceptHandler):
            if _is_broad_handler(node):
                self._handlers.append(_Handler(node, node.name))
        elif isinstance(node, ast.Raise):
            if self._handlers:
                self._handlers[-1].saved = True
        elif isinstance(node, ast.Name):
            for h in self._handlers:
                if h.bound is not None and node.id == h.bound:
                    h.saved = True

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.ExceptHandler) and self._handlers \
                and self._handlers[-1].node is node:
            h = self._handlers.pop()
            if not h.saved:
                what = ("bare 'except:'" if node.type is None
                        else "'except BaseException'")
                ctx.report(
                    "RPT302", node,
                    f"{what} can swallow WorkerKilled (a BaseException "
                    f"by contract) without re-raising or recording it",
                    "narrow to 'except Exception', or bind the exception "
                    "and record/re-raise it")

    @staticmethod
    def _check_np_random(node: ast.Call, ctx: FileContext) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Attribute)
                and f.value.attr == "random"
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id in ("np", "numpy")):
            return
        if f.attr in _ALLOWED_NP_RANDOM:
            return
        ctx.report("RPT301", node,
                   f"global-state 'np.random.{f.attr}(...)' call "
                   f"(import-order / thread-interleaving dependent)",
                   "draw from a seeded np.random.default_rng(...) "
                   "Generator instead")

    @staticmethod
    def _check_torch_random(node: ast.Call, ctx: FileContext) -> None:
        f = node.func
        if not isinstance(f, ast.Attribute):
            return
        recv = _dotted(f.value)
        seeded = any(kw.arg == "generator" for kw in node.keywords)
        if f.attr in _TORCH_SEEDS and recv in _TORCH_SEED_MODULES:
            ctx.report("RPT301", node,
                       f"'{recv}.{f.attr}(...)' seeds torch's global RNG",
                       "seed a torch.Generator and pass it as generator=")
        elif recv == "torch" and (f.attr in _TORCH_LIKE_DRAWS or
                                  (f.attr in _TORCH_DRAWS and not seeded)):
            ctx.report("RPT301", node,
                       f"'torch.{f.attr}(...)' draws from torch's global "
                       f"RNG",
                       "pass a seeded torch.Generator as generator= (a "
                       "*_like draw takes none: draw with the shape "
                       "instead)")
        elif f.attr in _TENSOR_DRAWS and not seeded:
            ctx.report("RPT301", node,
                       f"in-place '.{f.attr}(...)' draws from torch's "
                       f"global RNG",
                       "pass a seeded torch.Generator as generator=")
