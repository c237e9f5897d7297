"""Single-pass lint engine for the port's ``RPT`` rule set.

The port's copy of ``repro/analysis/engine.py``.  The engine parses each
Python file once and walks the tree exactly once, keeping a node stack.
Rules subscribe to node *types*; for every node the engine dispatches
``visit`` (pre-order) and ``leave`` (post-order) to the subscribed rules.
Rules emit :class:`Finding` objects through the shared
:class:`FileContext`; cross-file rules collect state and emit from
``finish()`` after every file has been walked.

CUDA sources (``*.cu``, ``*.cuh``) are not Python: the engine reads each
once and hands it to every rule's ``check_text`` (the kernel rules'
barrier and side-effect checks).  Python rules see only ``.py`` files.

Suppression: a physical line may carry ``# noqa: RPTnnn[, RPTnnn...]``
(``// noqa: ...`` in a CUDA source), with the three-digit rule id for
``nnn``.  The list may also name the reference analyzer's ``RPR`` codes,
and must name them *first*: that analyzer only reads ``RPR`` codes placed
directly after ``noqa:``, so a line that needs both writes the ``RPR``
codes, then the ``RPT`` ones, then ``-`` and the reason.  This engine
reads every ``RPT`` code in the list and ignores the rest.  Findings on
the line with a listed code are dropped and the suppression is marked
used; one that matches no finding is reported as ``RPT000`` (unused
suppression).  ``RPT000`` and ``RPT999`` (syntax error) cannot be
suppressed, and a blanket ``# noqa`` without codes is not honoured.

``report_only`` lets cross-file rules see the whole project while findings
are reported only for a subset; ``raw=True`` returns every finding with
suppressions off (the parity tests compare those with the reference's).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Type

__all__ = ["Finding", "Rule", "FileContext", "Engine", "main",
           "default_rules", "run_paths", "iter_files", "TEXT_SUFFIXES"]

_NOQA_RE = re.compile(
    r"(?:#|//)\s*noqa:\s*([A-Za-z]+\d+(?:\s*,\s*[A-Za-z]+\d+)*)",
    re.IGNORECASE)
_CODE_RE = re.compile(r"RPT\d{3}$")
#: suffixes of the CUDA sources handed to the text rules
TEXT_SUFFIXES = (".cu", ".cuh")
_UNSUPPRESSIBLE = ("RPT000", "RPT999")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint result: stable sort order is (path, line, rule)."""
    path: str
    line: int
    rule: str
    message: str
    hint: str = ""

    def render(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule}: {self.message}"
        if self.hint:
            out += f"  [fix: {self.hint}]"
        return out


class FileContext:
    """Per-file state shared by every rule during the walk.

    ``node_stack`` holds the ancestry of the node being visited (the node
    itself is last); ``parent()`` gives the immediate parent.  A CUDA
    source has no tree (``tree is None``) and reports by line.
    """

    def __init__(self, path: str, tree: Optional[ast.Module],
                 source: str) -> None:
        self.path = path
        self.tree = tree
        self.source = source
        self.lines = source.splitlines()
        self.node_stack: List[ast.AST] = []
        self.findings: List[Finding] = []

    def parent(self, back: int = 1) -> Optional[ast.AST]:
        i = len(self.node_stack) - 1 - back
        return self.node_stack[i] if i >= 0 else None

    def report(self, rule: str, node: ast.AST, message: str,
               hint: str = "") -> None:
        self.report_line(rule, int(getattr(node, "lineno", 1)), message,
                         hint)

    def report_line(self, rule: str, line: int, message: str,
                    hint: str = "") -> None:
        self.findings.append(Finding(self.path, line, rule, message, hint))


class Rule:
    """Base class.  Subclasses set ``types`` (node classes to receive) and
    override ``visit``/``leave``; cross-file rules override ``finish``;
    rules over CUDA sources override ``check_text``."""

    #: node types this rule wants ``visit``/``leave`` callbacks for
    types: Tuple[Type[ast.AST], ...] = ()

    def begin_file(self, ctx: FileContext) -> None:
        pass

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        pass

    def leave(self, node: ast.AST, ctx: FileContext) -> None:
        pass

    def end_file(self, ctx: FileContext) -> None:
        pass

    def check_text(self, ctx: FileContext) -> None:
        """Check one CUDA source (``ctx.tree`` is None)."""

    def finish(self) -> List[Finding]:
        """Cross-file findings, emitted after every file has been walked."""
        return []


class Engine:
    """Walks each file once, dispatching node events to subscribed rules."""

    def __init__(self, rules: Sequence[Rule]) -> None:
        self.rules = list(rules)
        self._by_type: Dict[Type[ast.AST], List[Rule]] = {}
        for rule in self.rules:
            for t in rule.types:
                self._by_type.setdefault(t, []).append(rule)
        #: per-file noqa maps kept for suppressing finish()-phase findings
        self._noqa: Dict[str, Dict[int, Set[str]]] = {}
        self.visited_nodes = 0  # instrumentation for the walker property test

    # ------------------------------------------------------------ per file

    @staticmethod
    def _collect_noqa(source: str) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _NOQA_RE.search(line)
            if m:
                codes = {c.strip().upper() for c in m.group(1).split(",")}
                codes = {c for c in codes if _CODE_RE.match(c)}
                if codes:
                    out[i] = codes
        return out

    def check_file(self, path: str, source: Optional[str] = None,
                   raw: bool = False) -> List[Finding]:
        """Check one file.  By default returns *suppression-filtered*
        findings plus RPT000 for unused suppressions; ``raw=True`` returns
        unfiltered findings (``run()`` applies suppression after the
        cross-file ``finish()`` phase instead)."""
        if source is None:
            source = Path(path).read_text()
        noqa = self._noqa[path] = self._collect_noqa(source)
        if path.endswith(TEXT_SUFFIXES):
            ctx = FileContext(path, None, source)
            for rule in self.rules:
                rule.check_text(ctx)
        else:
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                found = [Finding(path, int(e.lineno or 1), "RPT999",
                                 f"syntax error: {e.msg}")]
                return found if raw else self._apply_noqa(found, noqa, path)
            ctx = FileContext(path, tree, source)
            for rule in self.rules:
                rule.begin_file(ctx)
            self._walk(tree, ctx)
            for rule in self.rules:
                rule.end_file(ctx)
        if raw:
            return ctx.findings
        return self._apply_noqa(ctx.findings, noqa, path)

    def _walk(self, node: ast.AST, ctx: FileContext) -> None:
        self.visited_nodes += 1
        ctx.node_stack.append(node)
        for rule in self._by_type.get(type(node), ()):
            rule.visit(node, ctx)
        for child in ast.iter_child_nodes(node):
            self._walk(child, ctx)
        for rule in self._by_type.get(type(node), ()):
            rule.leave(node, ctx)
        ctx.node_stack.pop()

    # -------------------------------------------------------- suppression

    @staticmethod
    def _apply_noqa(findings: List[Finding], noqa: Dict[int, Set[str]],
                    path: str) -> List[Finding]:
        used: Set[Tuple[int, str]] = set()
        kept: List[Finding] = []
        for f in findings:
            if f.rule in noqa.get(f.line, ()) and \
                    f.rule not in _UNSUPPRESSIBLE:
                used.add((f.line, f.rule))
            else:
                kept.append(f)
        for line, codes in sorted(noqa.items()):
            for code in sorted(codes):
                if code in _UNSUPPRESSIBLE or (line, code) not in used:
                    kept.append(Finding(
                        path, line, "RPT000",
                        f"unused suppression: no {code} finding on this "
                        f"line",
                        f"delete the stale noqa ({code} cannot be "
                        f"suppressed)" if code in _UNSUPPRESSIBLE
                        else "delete the stale noqa"))
        return kept

    # ------------------------------------------------------------ project

    def run(self, paths: Iterable[str],
            report_only: Optional[Set[str]] = None,
            raw: bool = False) -> List[Finding]:
        """Analyze ``paths``; report findings for every path unless
        ``report_only`` restricts the reported subset (cross-file rules
        still see everything).  ``raw=True`` turns suppressions off."""
        by_path: Dict[str, List[Finding]] = {}
        for p in sorted(str(p) for p in paths):
            by_path[p] = self.check_file(p, raw=True)
        for rule in self.rules:
            for f in rule.finish():
                by_path.setdefault(f.path, []).append(f)
        findings: List[Finding] = []
        for p, found in by_path.items():
            if report_only is not None and p not in report_only:
                continue
            findings.extend(found if raw else
                            self._apply_noqa(found, self._noqa.get(p, {}), p))
        return sorted(findings)


def default_rules() -> List[Rule]:
    from .rules_determinism import DeterminismRules
    from .rules_kernels import KernelInvariantRules
    from .rules_locks import LockDisciplineRules
    return [LockDisciplineRules(), KernelInvariantRules(),
            DeterminismRules()]


def iter_files(root: Path) -> List[str]:
    """Every ``.py`` file and CUDA source under ``root``."""
    return sorted(str(p) for p in root.rglob("*")
                  if p.suffix in (".py", *TEXT_SUFFIXES) and p.is_file())


def run_paths(paths: Sequence[str],
              report_only: Optional[Set[str]] = None,
              raw: bool = False) -> List[Finding]:
    engine = Engine(default_rules())
    return engine.run(paths, report_only=report_only, raw=raw)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static analyzer (RPT rule set).")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--report-only", nargs="*", default=None, metavar="PATH",
                    help="analyze all PATHS for cross-file context but "
                         "report findings only for these files")
    args = ap.parse_args(argv)

    files: List[str] = []
    for p in args.paths:
        path = Path(p)
        files.extend(iter_files(path) if path.is_dir() else [str(path)])
    report_only = (None if args.report_only is None
                   else {str(Path(p)) for p in args.report_only})
    findings = run_paths(files, report_only=report_only)
    for f in findings:
        print(f.render())
    n = len(findings)
    print(f"repro_torch.analysis: {n} finding{'s' if n != 1 else ''} "
          f"in {len(files)} files")
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
