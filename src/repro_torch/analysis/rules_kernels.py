"""RPT2xx kernel invariant rules: the port's counterparts of
``repro/analysis/rules_kernels.py`` (RPR201-204), fitted to the Hopper
kernels (``kernels/csrc/*.cu``, C++ with a plain C interface) and to the
wrappers that launch them (``kernels/ops.py``), plus the port's
no-fallback rule.

Text rules over the CUDA sources (``*.cu``, ``*.cuh``; comments and string
literals are blanked first, so a helper's ``asm`` text or a comment never
matches):

* **RPT201** (RPR201, side effects in a kernel body) — ``printf``, a
  ``curand*`` call or file I/O (``fopen``, ``fprintf``, ``puts``, ...,
  ``std::cout``) inside a ``__global__`` or ``__device__`` body.  Device
  ``printf`` serialises through a host buffer and changes timing; device
  RNG makes a kernel disagree with its plain version.
* **RPT203** (RPR203, DMA start without wait) — within each
  ``__global__`` function, lexically and by root name as the reference
  matches semaphores (``full`` in ``&full[s]``): every ``mbar_init``'d
  barrier needs an arrival (``mbar_arrive*``, a consumer warp's
  ``mbar_arrive_warp`` on an "empty" barrier included) and an
  ``mbar_wait``; every ``bulk_load`` and every tensor-map load
  (``tma_load*``, whose barrier is its last argument) must complete on a
  barrier that is waited on; every
  ``bulk_store`` must be followed by a ``bulk_commit``, and the last
  ``bulk_commit`` by a drain (``bulk_wait<0>`` or ``bulk_wait_read<0>``)
  before the block exits and its shared memory is reused.  The helpers
  are ``csrc/tma.cuh``'s; a ring built by some other ``__device__``
  helper is not seen (one per-path analysis would need a C++ front end).

Python rules over the wrappers:

* **RPT202** (RPR202, aliased-output scatter without keep-last) — a call
  site of a keep-last scatter wrapper that neither calls ``np.unique`` /
  ``torch.unique`` nor documents the keep-last / last-writer contract in
  its docstring, and whose every caller does neither (two hops).  A
  wrapper is found structurally: a function that ``_launch``es a kernel
  of the ``cache_update`` library (``csrc/cache_update.cu``, K5/K6: GPU
  blocks write duplicate slots in no order), or one that applies
  ``index_copy_``/``index_put_`` to one of its arguments at indices that
  are also an argument (the caller supplies the ids).  A wrapper that
  dedupes or documents the contract itself is not a finding.  Cross-file.
* **RPT204** (RPR204, pipeline depth not sized against on-chip memory) —
  in a function taking ``depth``/``pipeline_depth``, an argument of a
  ``_launch`` call that derives from that parameter without passing
  ``_depth`` (the 1..4 range check), or that ``_check_ring`` (the
  shared-memory budget of the copy ring) has not seen before the launch.
  Flow is followed through plain assignments to names, in source order.
* **RPT205** (the port's no-fallback rule; the reference enforces it by
  having no fallback path) — (a) a ``try`` whose body calls ``_launch``,
  the kernel build (``library``, ``build_all``) or a function that
  reaches one of them, with a handler that neither re-raises nor uses the
  bound exception: a failed build or launch must not fall back to the
  plain version; (b) any ``torch.compile`` / ``torch._dynamo`` use: a
  compiled plain version is not a kernel of the port; (c) an ``import
  triton`` or a kernel build (``library``, ``build_all``,
  ``cpp_extension.load``/``load_inline``) outside a function body: builds
  are lazy, since the CPU tests import every module.  Reachability in (a)
  follows calls by bare name across files, as RPT202 does.
"""
from __future__ import annotations

import ast
import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Set, Tuple, Union

from .engine import FileContext, Finding, Rule

__all__ = ["KernelInvariantRules"]

_DEPTH_PARAMS = {"depth", "pipeline_depth"}
_DOC_MARKERS = ("keep-last", "last writer", "last-writer")
#: kernel names whose library is csrc/cache_update.cu
_SCATTER_LIBRARY = "cache_update"
_SCATTER_METHODS = {"index_copy_", "index_put_"}
#: calls that launch a kernel or build one
_LAUNCH = "_launch"
_BUILD_CALLS = {"library", "build_all"}
_EXT_BUILD_CALLS = {"load_inline"}

# ------------------------------------------------------------- CUDA text

_FUNC_KW_RE = re.compile(r"\b(__global__|__device__)\b")
_IDENT_RE = re.compile(r"[A-Za-z_]\w*")
_SIDE_EFFECT_RE = re.compile(
    r"\b(printf|curand\w*|fopen|fclose|fread|fwrite|fprintf|fscanf|fputs|"
    r"fgets|fputc|fgetc|fflush|puts|putchar)\s*\(|\bstd::(cout|cerr|clog)\b")
_BARRIER_CALL_RE = re.compile(
    r"\b(mbar_init|mbar_arrive\w*|mbar_wait|mbar_try_wait|bulk_load|"
    r"tma_load\w*|bulk_store|bulk_commit|bulk_wait\w*)\b")
_DRAIN_RE = re.compile(r"<\s*0\s*>")


def _blank_comments_and_strings(src: str) -> str:
    """``src`` with comments and string / char literals replaced by
    spaces (newlines kept, so offsets and lines are unchanged)."""
    out = list(src)
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif c in "\"'":
            j = i + 1
            while j < n and src[j] != c and src[j] != "\n":
                j += 2 if src[j] == "\\" else 1
            j = min(j + 1, n)
            for k in range(i + 1, j - 1):
                if out[k] != "\n":
                    out[k] = " "
            i = j
            continue
        else:
            i += 1
            continue
        for k in range(i, j):
            if out[k] != "\n":
                out[k] = " "
        i = j
    return "".join(out)


def _match_close(text: str, start: int) -> int:
    """Index of the bracket closing the one at ``start``, or -1."""
    pairs = {"(": ")", "{": "}", "[": "]"}
    open_c = text[start]
    close_c = pairs[open_c]
    depth = 0
    for i in range(start, len(text)):
        if text[i] == open_c:
            depth += 1
        elif text[i] == close_c:
            depth -= 1
            if depth == 0:
                return i
    return -1


@dataclasses.dataclass
class _CFunc:
    kind: str           # "__global__" | "__device__"
    name: str
    body: Tuple[int, int]   # offsets of "{" and its "}"


def _cuda_functions(text: str) -> List[_CFunc]:
    """The ``__global__`` / ``__device__`` functions with a body, in order.
    A keyword followed by ``;`` before any ``{`` is a declaration."""
    out: List[_CFunc] = []
    end = -1
    for m in _FUNC_KW_RE.finditer(text):
        if m.start() < end:
            continue  # inside the body of the previous function
        i, name = m.end(), "?"
        while i < len(text) and text[i] not in "{;":
            if text[i] == "(":
                before = _IDENT_RE.findall(text[m.end():i])
                if before:
                    name = before[-1]
                close = _match_close(text, i)
                if close < 0:
                    break
                i = close
            i += 1
        if i >= len(text) or text[i] != "{":
            continue
        close = _match_close(text, i)
        if close < 0:
            continue
        out.append(_CFunc(m.group(1), name, (i, close)))
        end = close
    return out


def _call_args(text: str, open_paren: int) -> List[str]:
    """The top-level comma-separated arguments of the call whose ``(`` is
    at ``open_paren``."""
    close = _match_close(text, open_paren)
    if close < 0:
        return []
    args, depth, cur = [], 0, []
    for c in text[open_paren + 1:close]:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == "," and depth == 0:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    args.append("".join(cur))
    return [a.strip() for a in args]


def _barrier_root(arg: str) -> Optional[str]:
    m = _IDENT_RE.search(arg.lstrip("&* ("))
    return m.group(0) if m else None


# ---------------------------------------------------------- Python AST


def _root_name(expr: ast.expr) -> Optional[str]:
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = getattr(expr, "value", None) or getattr(expr, "func", None)
        if expr is None:
            return None
    return expr.id if isinstance(expr, ast.Name) else None


def _call_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _dotted(expr: ast.expr) -> Optional[str]:
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


_FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


def _arg_names(node: _FuncNode) -> List[str]:
    a = node.args
    names = [x.arg for x in (a.posonlyargs + a.args + a.kwonlyargs)]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


def _static_prefix(expr: ast.expr) -> str:
    """The leading constant text of a string or f-string, else ''."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr) and expr.values and \
            isinstance(expr.values[0], ast.Constant):
        return str(expr.values[0].value)
    return ""


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _swallows(h: ast.ExceptHandler) -> bool:
    """Neither re-raises nor uses the bound exception."""
    for n in ast.walk(h):
        if isinstance(n, ast.Raise) and n is not h:
            return False
        if h.name and isinstance(n, ast.Name) and n.id == h.name:
            return False
    return True


@dataclasses.dataclass
class _Func:
    node: ast.AST
    name: str
    params: Set[str]
    doc_marked: bool
    calls: Set[str] = dataclasses.field(default_factory=set)
    has_unique: bool = False
    scatters: bool = False
    # RPT204: names derived from a depth parameter, before / after _depth,
    # and the checked ones that _check_ring has seen
    raw: Set[str] = dataclasses.field(default_factory=set)
    ranged: Set[str] = dataclasses.field(default_factory=set)
    ringed: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _FuncInfo:
    path: str
    line: int
    marked: bool
    calls: Set[str]
    scatters: bool


@dataclasses.dataclass
class _TryInfo:
    path: str
    calls: Set[str]
    handler_lines: List[int]


class KernelInvariantRules(Rule):
    types = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Call,
             ast.Assign, ast.AnnAssign, ast.Try, ast.Attribute, ast.Import,
             ast.ImportFrom)

    def __init__(self) -> None:
        self._stack: List[_Func] = []
        # cross-file call graph: bare name -> merged info
        self._funcs: Dict[str, _FuncInfo] = {}
        self._tries: List[_TryInfo] = []

    # ----------------------------------------------------------- lifecycle

    def begin_file(self, ctx: FileContext) -> None:
        self._stack = []

    # ------------------------------------------------------------- events

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            self._enter(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            self._on_assign(node)
        elif isinstance(node, ast.Call):
            self._on_call(node, ctx)
        elif isinstance(node, ast.Try):
            self._on_try(node, ctx)
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and \
                    node.value.id == "torch" and \
                    node.attr in ("compile", "_dynamo"):
                ctx.report("RPT205", node,
                           f"'torch.{node.attr}' in the port (a compiled "
                           f"plain version is not a kernel)",
                           "launch the hand-written kernel through "
                           "kernels.ops")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            self._on_import(node, ctx)

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            return
        if not self._stack or self._stack[-1].node is not node:
            return
        rec = self._stack.pop()
        if isinstance(node, ast.Lambda):
            # a lambda's calls belong to the function that holds it
            if self._stack:
                self._stack[-1].calls |= rec.calls
                self._stack[-1].has_unique |= rec.has_unique
            return
        if not self._stack:  # module-level def: record for the call graph
            prev = self._funcs.get(rec.name)
            info = _FuncInfo(ctx.path, node.lineno,
                             rec.has_unique or rec.doc_marked,
                             set(rec.calls), rec.scatters)
            if prev is not None:  # same bare name elsewhere: merge
                info.marked = info.marked or prev.marked
                info.calls |= prev.calls
                info.scatters = info.scatters or prev.scatters
            self._funcs[rec.name] = info
        else:
            # nested defs contribute their calls to the enclosing function
            self._stack[0].calls |= rec.calls
            self._stack[0].has_unique |= rec.has_unique
            self._stack[0].scatters |= rec.scatters

    # ------------------------------------------------------------- helpers

    def _enter(self, node: _FuncNode) -> None:
        params = set(_arg_names(node))
        if isinstance(node, ast.Lambda):
            rec = _Func(node, "<lambda>", params, False)
            if self._stack:  # a lambda sees its function's depth names
                outer = self._stack[-1]
                rec.raw, rec.ranged, rec.ringed = (
                    set(outer.raw), set(outer.ranged), set(outer.ringed))
            self._stack.append(rec)
            return
        doc = ast.get_docstring(node) or ""
        doc_norm = " ".join(doc.split()).lower()
        rec = _Func(node, node.name, params,
                    any(m in doc_norm for m in _DOC_MARKERS))
        rec.raw = params & _DEPTH_PARAMS
        self._stack.append(rec)

    def _on_assign(self, node: Union[ast.Assign, ast.AnnAssign]) -> None:
        rec = self._stack[-1] if self._stack else None
        value = getattr(node, "value", None)
        if rec is None or value is None or not (rec.raw or rec.ranged):
            return
        used = _names_in(value)
        if isinstance(value, ast.Call) and _call_name(value.func) == \
                "_depth" and used & (rec.raw | rec.ranged):
            status = "ranged"
        elif used & rec.raw:
            status = "raw"
        elif used & rec.ranged:
            status = "ranged"
        else:
            status = ""
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            for name in _names_in(t):
                for s in (rec.raw, rec.ranged, rec.ringed):
                    s.discard(name)
                if status == "raw":
                    rec.raw.add(name)
                elif status == "ranged":
                    rec.ranged.add(name)

    def _on_call(self, node: ast.Call, ctx: FileContext) -> None:
        f = node.func
        name = _call_name(f)
        self._check_module_build(node, name, ctx)
        rec = self._stack[-1] if self._stack else None
        if rec is None:
            return
        if name is not None:
            rec.calls.add(name)
        if name == "unique" and isinstance(f, ast.Attribute) \
                and _root_name(f.value) in ("np", "numpy", "torch"):
            rec.has_unique = True
        if name == _LAUNCH and any(
                _static_prefix(a).startswith(_SCATTER_LIBRARY)
                for a in node.args[:2]):
            rec.scatters = True
        if name in _SCATTER_METHODS and isinstance(f, ast.Attribute) \
                and _root_name(f.value) in rec.params:
            index = node.args[1] if name == "index_copy_" and \
                len(node.args) > 1 else (node.args[0] if node.args
                                         else None)
            if index is not None and _names_in(index) & rec.params:
                rec.scatters = True
        if name == "_check_ring":
            for a in node.args:
                rec.ringed |= _names_in(a) & rec.ranged
        elif name == _LAUNCH:
            self._check_launch_depth(node, rec, ctx)

    def _check_launch_depth(self, node: ast.Call, rec: _Func,
                            ctx: FileContext) -> None:
        used: Set[str] = set()
        for a in node.args:
            used |= _names_in(a)
        raw = sorted(used & rec.raw)
        unringed = sorted((used & rec.ranged) - rec.ringed)
        if raw:
            ctx.report("RPT204", node,
                       f"'{rec.name}' passes '{raw[0]}', derived from its "
                       f"pipeline depth, to _launch without the _depth "
                       f"range check",
                       "validate with depth = _depth(pipeline_depth) first")
        elif unringed:
            ctx.report("RPT204", node,
                       f"'{rec.name}' passes pipeline depth "
                       f"'{unringed[0]}' to _launch without sizing its "
                       f"copy ring via _check_ring",
                       "call _check_ring(kernel, depth, rows, width, "
                       "elem_bytes) before the launch")

    def _on_try(self, node: ast.Try, ctx: FileContext) -> None:
        swallowing = [h.lineno for h in node.handlers if _swallows(h)]
        if not swallowing:
            return
        calls: Set[str] = set()
        for stmt in node.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    name = _call_name(n.func)
                    if name is not None:
                        calls.add(name)
        self._tries.append(_TryInfo(ctx.path, calls, swallowing))

    def _in_function(self, ctx: FileContext) -> bool:
        return any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)) for n in ctx.node_stack)

    def _check_module_build(self, node: ast.Call, name: Optional[str],
                            ctx: FileContext) -> None:
        dotted = _dotted(node.func) or ""
        if not (name in _BUILD_CALLS or name in _EXT_BUILD_CALLS
                or dotted.endswith("cpp_extension.load")):
            return
        if self._in_function(ctx):
            return
        ctx.report("RPT205", node,
                   f"kernel build '{dotted or name}(...)' at import time",
                   "build on first use, inside the function that launches")

    def _on_import(self, node: ast.AST, ctx: FileContext) -> None:
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
            if mods == ["torch"]:
                mods = [f"torch.{a.name}" for a in node.names]
        else:
            mods = []
        for mod in mods:
            if mod.split(".")[0] == "triton" and not self._in_function(ctx):
                ctx.report("RPT205", node,
                           "module-level 'import triton' (builds must be "
                           "lazy: the CPU tests import every module)",
                           "import triton inside the function that "
                           "launches the kernel")
            elif mod in ("torch.compile", "torch._dynamo") or \
                    mod.startswith("torch._dynamo."):
                ctx.report("RPT205", node,
                           f"'{mod}' imported in the port (a compiled plain "
                           f"version is not a kernel)",
                           "launch the hand-written kernel through "
                           "kernels.ops")

    # ------------------------------------------------------- CUDA sources

    def check_text(self, ctx: FileContext) -> None:
        text = _blank_comments_and_strings(ctx.source)
        starts = [0] + [i + 1 for i, c in enumerate(text) if c == "\n"]

        def line_of(offset: int) -> int:
            return bisect.bisect_right(starts, offset)

        for fn in _cuda_functions(text):
            lo, hi = fn.body
            body = text[lo:hi]
            for m in _SIDE_EFFECT_RE.finditer(body):
                what = m.group(1) or f"std::{m.group(2)}"
                ctx.report_line("RPT201", line_of(lo + m.start()),
                                f"'{what}' inside {fn.kind} function "
                                f"'{fn.name}' (a side effect in a kernel "
                                f"body)",
                                "kernels must be side-effect-free: count "
                                "into an output buffer instead")
            if fn.kind == "__global__":
                self._check_ring_balance(ctx, fn, text, line_of)

    @staticmethod
    def _check_ring_balance(ctx: FileContext, fn: _CFunc, text: str,
                            line_of) -> None:
        lo, hi = fn.body
        inits: Dict[str, int] = {}
        arrived: Set[str] = set()
        waited: Set[str] = set()
        loads: List[Tuple[str, str, int]] = []
        stores: List[int] = []
        commits: List[int] = []
        drains: List[int] = []
        for m in _BARRIER_CALL_RE.finditer(text, lo, hi):
            call, at = m.group(1), m.start()
            paren = text.find("(", m.end())
            args = _call_args(text, paren) if paren >= 0 else []
            first = _barrier_root(args[0]) if args else None
            if call == "mbar_init" and first:
                inits.setdefault(first, at)
            elif call.startswith("mbar_arrive") and first:
                arrived.add(first)
            elif call in ("mbar_wait", "mbar_try_wait") and first:
                waited.add(first)
            elif call == "bulk_load":
                bar = _barrier_root(args[-1]) if len(args) == 4 else None
                loads.append((call, bar or "?", at))
            elif call.startswith("tma_load"):
                # a tensor-map load: (dst, map, coordinates..., barrier)
                bar = _barrier_root(args[-1]) if len(args) >= 4 else None
                loads.append((call, bar or "?", at))
            elif call == "bulk_store":
                stores.append(at)
            elif call == "bulk_commit":
                commits.append(at)
            elif call.startswith("bulk_wait") and \
                    _DRAIN_RE.match(text, m.end()):
                drains.append(at)
        for bar, at in sorted(inits.items(), key=lambda kv: kv[1]):
            missing = [w for w, seen in (("arrival (mbar_arrive*)",
                                          bar in arrived),
                                         ("mbar_wait", bar in waited))
                       if not seen]
            if missing:
                ctx.report_line("RPT203", line_of(at),
                                f"kernel '{fn.name}' initialises barrier "
                                f"'{bar}' but has no "
                                f"{' or '.join(missing)} on it",
                                f"pair every phase of '{bar}' with an "
                                f"arrival and an mbar_wait before its "
                                f"slot is reused")
        for call, bar, at in loads:
            if bar not in waited:
                ctx.report_line("RPT203", line_of(at),
                                f"kernel '{fn.name}' issues a {call} "
                                f"completing on '{bar}', which is never "
                                f"waited on",
                                f"mbar_wait on '{bar}' before reading the "
                                f"loaded stage")
        for at in stores:
            if not any(c > at for c in commits):
                ctx.report_line("RPT203", line_of(at),
                                f"kernel '{fn.name}' issues a bulk_store "
                                f"that no later bulk_commit closes",
                                "bulk_commit() after the store")
        if commits and not any(d > commits[-1] for d in drains):
            ctx.report_line("RPT203", line_of(commits[-1]),
                            f"kernel '{fn.name}' commits bulk stores but "
                            f"never drains them (bulk_wait<0> or "
                            f"bulk_wait_read<0>) after the last commit",
                            "bulk_wait<0>() before the block exits")

    # ------------------------------------------------------------- project

    def finish(self) -> List[Finding]:
        return self._finish_keep_last() + self._finish_fallback()

    def _callers(self) -> Dict[str, Set[str]]:
        callers: Dict[str, Set[str]] = {}
        for fname, info in self._funcs.items():
            for callee in info.calls:
                if callee in self._funcs:
                    callers.setdefault(callee, set()).add(fname)
        return callers

    def _finish_keep_last(self) -> List[Finding]:
        out: List[Finding] = []
        callers = self._callers()

        def marked(n: str) -> bool:
            return self._funcs[n].marked

        for wname, winfo in sorted(self._funcs.items()):
            if not winfo.scatters or marked(wname):
                continue
            for c in sorted(callers.get(wname, ())):
                if marked(c):
                    continue
                c2 = callers.get(c, set())
                if c2 and all(marked(x) for x in c2):
                    continue
                ci = self._funcs[c]
                out.append(Finding(
                    ci.path, ci.line, "RPT202",
                    f"'{c}' reaches keep-last scatter wrapper '{wname}' "
                    f"without the keep-last dedupe contract within two "
                    f"caller hops",
                    "route through ops.update_cache_rows or dedupe the "
                    "slots keep-last (np.unique on the reversed slot "
                    "list) before the scatter"))
        return out

    def _finish_fallback(self) -> List[Finding]:
        reach = {_LAUNCH, *_BUILD_CALLS}
        grew = True
        while grew:
            grew = False
            for fname, info in self._funcs.items():
                if fname not in reach and info.calls & reach:
                    reach.add(fname)
                    grew = True
        out: List[Finding] = []
        for t in self._tries:
            hit = sorted(t.calls & reach)
            if not hit:
                continue
            for line in t.handler_lines:
                out.append(Finding(
                    t.path, line, "RPT205",
                    f"handler swallows a failure of a try body that "
                    f"reaches a kernel launch or build (via '{hit[0]}'): "
                    f"no fallback from a failed kernel",
                    "re-raise, or record the bound exception"))
        self._tries = []
        return out
