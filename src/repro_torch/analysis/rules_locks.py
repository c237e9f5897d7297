"""RPT1xx lock-discipline rules (plus RPT303 counter accounting).

The port's counterpart of ``repro/analysis/rules_locks.py`` (RPR101-104
and RPR303), with the same rule numbers and scoping model.  Classes opt in
with ``@guarded_by("<lock>", "<attr>", ...)`` from
``repro_torch.annotations`` (read *syntactically*: the analyzer never
imports the code under analysis).  Within an annotated class:

* **RPT101** — read of a guarded attribute outside ``with self.<lock>:``.
* **RPT104** — write (assignment / del) of a guarded attribute outside
  the lock.
* **RPT303** — augmented assignment (``+=`` et al.) on a guarded stats
  counter outside the lock: the accounting-symmetry rule.
* **RPT102** — lock acquisition order inversion: ``with self.A: with
  self.B:`` in one place and ``with self.B: with self.A:`` in another
  (same class); both sites are reported.
* **RPT103** — blocking call inside a ``with <lock>:`` body.  The
  reference's set (``.take()`` gathers, ``tofile``, ``fsync``,
  ``block_until_ready``, ``device_put``, ``sleep``, ``join``, ``result``,
  ``open()``, with its exemptions: a numpy-receiver ``take``, a string's
  or ``os.path``'s ``join``) plus what blocks the host in torch:

  - ``.synchronize()`` on any receiver (``torch.cuda.synchronize``, a
    stream, an event).  Edge: a user method of that name is flagged too.
  - ``.item()``, ``.tolist()`` and ``.cpu()``: each waits for the device
    when its receiver lies there.  Edge: the receiver's type is not
    known, so a numpy array's ``item``/``tolist`` (host memory, cheap) and
    a CPU tensor's ``cpu()`` (a no-op) are flagged alike.
  - ``.to(...)`` and ``.cuda(...)`` that name a device (a ``device=``
    keyword, a string such as ``"cuda:0"``, a ``torch.device(...)``, or a
    name or attribute ending in ``device`` or ``dev``) without
    ``non_blocking=True``; ``.cuda()`` always names one.  A
    ``.copy_(...)`` without ``non_blocking=True`` whose receiver or
    arguments name a device anywhere
    (``torch.empty(n, device=dev).copy_(host)``).  Edges: a
    ``.to(other_tensor)`` or a ``dst.copy_(src)`` between two devices
    names none and is not seen; a ``.to(dev)`` that turns out to be the
    tensor's own device is flagged although it copies nothing.
  - ``torch.save`` / ``torch.load`` (file I/O and pickling).
  - ``torch.distributed``'s collectives, point-to-point calls and
    ``barrier``, called through the module (``dist.all_reduce``, however
    it was imported) or by a name imported from it: under gloo each
    blocks until every rank has joined.  Edge: a collective reached
    through a ``ProcessGroup`` object's methods is not seen.

Scope model: each function body is a frame with its own held-lock set.
``__init__``/``__del__`` are exempt (the object is not yet / no longer
shared).  Nested ``def``/``lambda`` bodies start with *no* held locks —
a closure created under a lock may run on another thread after the lock
is released, so inheriting the lexical lock set would be unsound.
``@requires_lock("<lock>")`` marks helpers whose contract is that the
caller already holds the lock.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .engine import FileContext, Finding, Rule

__all__ = ["LockDisciplineRules"]

#: the reference's attribute calls that block while a declared lock is held
_BLOCKING_ATTRS = {"take", "tofile", "fsync", "block_until_ready",
                   "device_put", "sleep", "join", "result"}
#: torch calls that wait for the device whatever their arguments
_TORCH_BLOCKING_ATTRS = {"synchronize", "item", "tolist", "cpu"}
#: host <-> device copies: blocking unless ``non_blocking=True``
_COPY_ATTRS = {"to", "cuda", "copy_"}
#: ``torch.distributed`` calls that wait for every rank
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "broadcast", "broadcast_object_list", "reduce", "gather",
                "gather_object", "scatter", "scatter_object_list", "send",
                "recv", "barrier", "monitored_barrier"}
#: receivers whose ``.take`` is a cheap in-memory gather, not storage I/O
_CHEAP_TAKE_RECEIVERS = {"np", "numpy", "jnp"}
_EXEMPT_METHODS = {"__init__", "__del__"}
_DEVICE_STRINGS = ("cpu", "cuda", "meta")


@dataclasses.dataclass
class _ClassInfo:
    name: str
    guarded: Dict[str, str]        # attr -> lock name
    locks: Set[str]                # every declared lock name


@dataclasses.dataclass
class _Frame:
    node: ast.AST
    cls: Optional[_ClassInfo]
    exempt: bool
    held: List[str] = dataclasses.field(default_factory=list)
    # with-nodes to the number of locks they pushed, for the leave pop
    with_counts: List[Tuple[ast.AST, int]] = dataclasses.field(
        default_factory=list)


def _decorator_call(dec: ast.expr, name: str) -> Optional[ast.Call]:
    if isinstance(dec, ast.Call):
        f = dec.func
        if (isinstance(f, ast.Name) and f.id == name) or \
           (isinstance(f, ast.Attribute) and f.attr == name):
            return dec
    return None


def _str_args(call: ast.Call) -> List[str]:
    out = []
    for a in call.args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            out.append(a.value)
    return out


def _root_name(expr: ast.expr) -> Optional[str]:
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _dotted(expr: ast.expr) -> Optional[str]:
    """``a.b.c`` for a chain of names, else None."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _names_device(expr: ast.expr) -> bool:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":")[0] in _DEVICE_STRINGS
    if isinstance(expr, ast.Call):
        return _dotted(expr.func) == "torch.device"
    last = (expr.id if isinstance(expr, ast.Name) else
            expr.attr if isinstance(expr, ast.Attribute) else "")
    return last.endswith(("device", "dev"))


def _blocking_copy(call: ast.Call, f: ast.Attribute) -> bool:
    """A ``.to``/``.cuda``/``.copy_`` that names a device and is not
    ``non_blocking=True``; a ``copy_`` names one anywhere in its receiver
    or arguments (``torch.empty(n, device=dev).copy_(host)``)."""
    for kw in call.keywords:
        if kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return False
    if f.attr == "cuda" or any(kw.arg == "device" for kw in call.keywords):
        return True
    if f.attr != "copy_":
        return any(_names_device(a) for a in call.args)
    exprs = [f.value, *call.args]
    return any(_names_device(n) if isinstance(n, ast.expr) else
               isinstance(n, ast.keyword) and n.arg == "device"
               for e in exprs for n in ast.walk(e))


class LockDisciplineRules(Rule):
    types = (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef,
             ast.Lambda, ast.With, ast.Attribute, ast.Call, ast.Import,
             ast.ImportFrom)

    def __init__(self) -> None:
        # (class, inner_first, outer_first) -> first (path, line) observed
        self._order: Dict[Tuple[str, str, str], Tuple[str, int]] = {}
        self._class_stack: List[Optional[_ClassInfo]] = []
        self._frames: List[_Frame] = []
        # this file's names for torch.distributed and for its collectives
        self._dist_modules: Set[str] = set()
        self._dist_calls: Set[str] = set()

    # ----------------------------------------------------------- lifecycle

    def begin_file(self, ctx: FileContext) -> None:
        self._class_stack = []
        self._frames = []
        self._dist_modules = {"torch.distributed"}
        self._dist_calls = set()

    # --------------------------------------------------------------- class

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.ClassDef):
            self._class_stack.append(self._parse_class(node))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._enter_function(node, ctx)
        elif isinstance(node, ast.Lambda):
            cls = self._frames[-1].cls if self._frames else None
            self._frames.append(_Frame(node, cls, exempt=False))
        elif isinstance(node, ast.With):
            self._enter_with(node, ctx)
        elif isinstance(node, ast.Attribute):
            self._check_attribute(node, ctx)
        elif isinstance(node, ast.Call):
            self._check_blocking(node, ctx)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            self._note_dist_import(node)

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.ClassDef):
            self._class_stack.pop()
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            if self._frames and self._frames[-1].node is node:
                self._frames.pop()
        elif isinstance(node, ast.With):
            fr = self._frames[-1] if self._frames else None
            if fr and fr.with_counts and fr.with_counts[-1][0] is node:
                _, n = fr.with_counts.pop()
                for _ in range(n):
                    fr.held.pop()

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _parse_class(node: ast.ClassDef) -> Optional[_ClassInfo]:
        guarded: Dict[str, str] = {}
        locks: Set[str] = set()
        for dec in node.decorator_list:
            call = _decorator_call(dec, "guarded_by")
            if call is not None:
                names = _str_args(call)
                if names:
                    lock, attrs = names[0], names[1:]
                    locks.add(lock)
                    for a in attrs:
                        guarded[a] = lock
        if not locks:
            return None
        return _ClassInfo(node.name, guarded, locks)

    def _enter_function(self, node: ast.FunctionDef,
                        ctx: FileContext) -> None:
        parent = ctx.parent()
        is_method = isinstance(parent, ast.ClassDef) and \
            bool(self._class_stack) and self._class_stack[-1] is not None
        cls = self._class_stack[-1] if is_method else (
            self._frames[-1].cls if self._frames else None)
        exempt = is_method and node.name in _EXEMPT_METHODS
        frame = _Frame(node, cls, exempt)
        if cls is not None:
            for dec in node.decorator_list:
                call = _decorator_call(dec, "requires_lock")
                if call is not None:
                    frame.held.extend(_str_args(call))
        self._frames.append(frame)

    def _enter_with(self, node: ast.With, ctx: FileContext) -> None:
        fr = self._frames[-1] if self._frames else None
        if fr is None or fr.cls is None:
            return
        acquired = []
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Attribute) and \
                    isinstance(e.value, ast.Name) and e.value.id == "self" \
                    and e.attr in fr.cls.locks:
                acquired.append(e.attr)
        if not acquired:
            return
        for new in acquired:
            for outer in fr.held:
                if outer != new:
                    key = (fr.cls.name, outer, new)
                    self._order.setdefault(key, (ctx.path, node.lineno))
            fr.held.append(new)
        fr.with_counts.append((node, len(acquired)))

    def _check_attribute(self, node: ast.Attribute,
                         ctx: FileContext) -> None:
        fr = self._frames[-1] if self._frames else None
        if fr is None or fr.cls is None or fr.exempt:
            return
        if not (isinstance(node.value, ast.Name) and node.value.id == "self"):
            return
        lock = fr.cls.guarded.get(node.attr)
        if lock is None or lock in fr.held:
            return
        parent = ctx.parent()
        if isinstance(parent, ast.AugAssign) and parent.target is node:
            ctx.report("RPT303", node,
                       f"augmented update of guarded counter "
                       f"'self.{node.attr}' outside 'with self.{lock}:' "
                       f"(lost-update race)",
                       f"move the += under 'with self.{lock}:'")
        elif isinstance(node.ctx, (ast.Store, ast.Del)):
            ctx.report("RPT104", node,
                       f"write to guarded attribute 'self.{node.attr}' "
                       f"outside 'with self.{lock}:'",
                       f"wrap in 'with self.{lock}:'")
        else:
            ctx.report("RPT101", node,
                       f"read of guarded attribute 'self.{node.attr}' "
                       f"outside 'with self.{lock}:'",
                       f"wrap in 'with self.{lock}:' or snapshot under "
                       f"the lock")

    def _note_dist_import(self, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    self._dist_modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    self._dist_modules.add(a.asname or a.name)
                elif node.module == "torch.distributed" \
                        and a.name in _COLLECTIVES:
                    self._dist_calls.add(a.asname or a.name)

    def _blocking_name(self, node: ast.Call) -> Optional[str]:
        f = node.func
        if isinstance(f, ast.Name):
            if f.id == "open" or f.id in self._dist_calls:
                return f.id
            return None
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr in _BLOCKING_ATTRS:
            recv = _root_name(f.value)
            if f.attr == "take" and recv in _CHEAP_TAKE_RECEIVERS:
                return None
            # '...'.join(seq) string building and os.path.join are pure
            # CPU — only thread/process/pool joins block
            if f.attr == "join" and (isinstance(f.value, ast.Constant)
                                     or recv == "os"):
                return None
            return f.attr
        if f.attr in _TORCH_BLOCKING_ATTRS:
            return f.attr
        if f.attr in _COPY_ATTRS and _blocking_copy(node, f):
            return f.attr
        recv = _dotted(f.value)
        if f.attr in ("save", "load") and recv == "torch":
            return f"torch.{f.attr}"
        if f.attr in _COLLECTIVES and recv in self._dist_modules:
            return f"{recv}.{f.attr}"
        return None

    def _check_blocking(self, node: ast.Call, ctx: FileContext) -> None:
        fr = self._frames[-1] if self._frames else None
        if fr is None or not fr.held:
            return
        name = self._blocking_name(node)
        if name is not None:
            held = ", ".join(f"self.{k}" for k in fr.held)
            ctx.report("RPT103", node,
                       f"blocking call '{name}(...)' while holding {held}",
                       "stage the slow work outside the lock and publish "
                       "the result under it (the staged-gather pattern)")

    # ------------------------------------------------------------- project

    def finish(self) -> List[Finding]:
        out: List[Finding] = []
        for (cls, a, b), (path, line) in sorted(self._order.items()):
            if a < b and (cls, b, a) in self._order:
                other_path, other_line = self._order[(cls, b, a)]
                out.append(Finding(
                    path, line, "RPT102",
                    f"lock order inversion in {cls}: self.{a} -> self.{b} "
                    f"here but self.{b} -> self.{a} at "
                    f"{other_path}:{other_line}",
                    "pick one global acquisition order for these locks"))
                out.append(Finding(
                    other_path, other_line, "RPT102",
                    f"lock order inversion in {cls}: self.{b} -> self.{a} "
                    f"here but self.{a} -> self.{b} at {path}:{line}",
                    "pick one global acquisition order for these locks"))
        return out
