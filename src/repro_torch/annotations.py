"""Zero-cost concurrency annotations read by the ``repro.analysis`` linter.

The port keeps its own copy of ``repro/analysis/annotations.py`` so that
``repro_torch`` imports nothing of the JAX package; the analyzer matches the
decorator names syntactically, so both copies are checked alike.

The data plane (storage window LRU, cache refresh staging, prefetch worker,
pipeline stages) mutates shared state from several host threads.  Each lock
protects a *declared family of attributes*; the declaration lives on the
class as a decorator so the static analyzer (``repro.analysis``) can check,
purely syntactically, that every read/write of a guarded attribute happens
inside a ``with self.<lock>:`` block.

The decorators attach metadata and return the class/function **unchanged**
— no wrappers, no per-call overhead, importable from any module without
pulling in the analyzer itself.

Annotation pattern for a new threaded module
--------------------------------------------

::

    from repro_torch.annotations import guarded_by, requires_lock

    @guarded_by("_lock", "pending", "completed", "errors")
    @guarded_by("_io_lock", "io_retries")        # one decorator per lock
    class ShardServer:
        def __init__(self):
            self._lock = threading.Lock()        # __init__ is exempt:
            self.pending = 0                     # the object is not yet
            self._io_lock = threading.Lock()     # visible to other threads
            self.io_retries = 0

        def submit(self, n):
            with self._lock:
                self.pending += n                # OK: under the right lock

        @requires_lock("_lock")
        def _drain_locked(self):
            # caller holds _lock (convention enforced at call sites)
            self.pending = 0                     # OK: declared held

        def peek(self):
            return self.pending                  # RPR101: read outside lock

What the analyzer enforces (see docs/static-analysis.md for the catalog):

* RPR101 / RPR104 — guarded attribute read / write outside the lock.
* RPR303 — ``+=`` on a guarded stats counter outside the lock (the
  accounting-symmetry rule: lost updates silently corrupt ``health()``).
* RPR102 — lock acquisition order inversions across declared locks.
* RPR103 — blocking calls (jax dispatch, ``.take()`` gathers, file I/O,
  sleeps) inside a ``with <lock>:`` body.

False positives are suppressed per line with a reason::

    self.version = v  # noqa: RPR1xx - benign: single writer (use the real
                      # three-digit rule id; placeholder shown here so this
                      # docstring is not itself parsed as a suppression)

Deliberately *undeclared* attributes (single-producer history deques,
last-writer-wins monitors) are simply left out of the ``guarded_by`` list;
the declaration is the opt-in.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, TypeVar

__all__ = ["guarded_by", "requires_lock"]

_C = TypeVar("_C", bound=type)
_F = TypeVar("_F", bound=Callable[..., object])


def guarded_by(lock: str, *attrs: str) -> Callable[[_C], _C]:
    """Declare that ``lock`` (an attribute name, e.g. ``"_lock"``) protects
    the named instance attributes.  Stack one decorator per lock.

    The analyzer reads the declaration from the AST; at runtime this only
    records a ``__guarded_by__`` mapping on the class for introspection.
    """
    if not lock or not all(isinstance(a, str) and a for a in attrs):
        raise ValueError("guarded_by(lock, *attrs) takes non-empty strings")

    def deco(cls: _C) -> _C:
        merged: Dict[str, Tuple[str, ...]] = dict(
            getattr(cls, "__guarded_by__", {}))
        merged[lock] = tuple(dict.fromkeys(merged.get(lock, ()) + attrs))
        cls.__guarded_by__ = merged  # type: ignore[attr-defined]
        return cls

    return deco


def requires_lock(*locks: str) -> Callable[[_F], _F]:
    """Declare that every caller of this method already holds ``locks``.

    The analyzer treats the method body as if it were inside
    ``with self.<lock>:`` for each named lock; the docstring should say the
    same for human readers.  Runtime cost: one attribute set at class
    definition time, nothing per call.
    """
    if not locks or not all(isinstance(k, str) and k for k in locks):
        raise ValueError("requires_lock(*locks) takes non-empty strings")

    def deco(fn: _F) -> _F:
        fn.__requires_lock__ = tuple(locks)  # type: ignore[attr-defined]
        return fn

    return deco
