"""Lint engine of the port: findings, suppressions, and the baseline diff
gate, the counterpart of the JAX package's ``analysis.engine``.

The engine is rule-agnostic: it walks ``src/repro_torch/**/*.py``, parses
each file once into a :class:`Module` (AST + source lines + suppression
map), runs every rule whose path scope matches, and filters the findings
through two layers:

  * **inline suppressions** — ``# repro: allow[rule-id]`` (comma list or
    ``*``) on the finding's line or the line directly above it, the JAX
    package's marker, so one comment grammar serves both packages.  Each
    suppression must justify itself in prose on the same comment; a
    suppression that matched nothing is itself reported (rule
    ``unused-allow``), so stale allows cannot accumulate;
  * **baseline** — ``baseline.json`` beside this module (never the JAX
    package's ``analysis_baseline.json``) holds findings grandfathered past
    the gate, each with a ``note``.  ``--check`` fails only on findings NOT
    in the baseline.  The file keeps the JAX package's format byte for
    byte.

Finding identity for baseline matching is ``(rule, path, symbol,
message)`` — deliberately line-number-free, so unrelated edits above a
baselined finding do not resurrect it.

Stdlib only: ``default_root`` comes from this file's location, because
importing ``repro_torch`` would import torch.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "Module", "Rule", "parse_module", "run_rules",
           "load_baseline", "diff_against_baseline", "iter_source_files",
           "default_root", "default_baseline", "write_baseline"]

# Matches the suppression marker (hash, "repro:", then a bracketed comma
# list of rule ids or "*"); prose after the bracket is the justification.
# Worded to not match itself — Module scans real comment tokens.
_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([a-z0-9_*,\s\-]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str           # posix path relative to the scan root's parent
    line: int
    col: int
    message: str
    symbol: str = ""    # enclosing ClassName.function, for stable keys

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "symbol": self.symbol,
                "message": self.message}

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{sym}: " \
               f"{self.message}"


class Module:
    """One parsed source file plus its suppression map."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # line -> set of rule ids allowed there ('*' allows every rule).
        # Scanned over real COMMENT tokens, not raw lines, so docstrings
        # *describing* the allow syntax don't register as suppressions.
        self.allows: Dict[int, Set[str]] = {}
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(source).readline))
        except (tokenize.TokenizeError, SyntaxError, IndentationError):
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ALLOW_RE.search(tok.string)
            if m:
                ids = {t.strip() for t in m.group(1).split(",") if t.strip()}
                self.allows[tok.start[0]] = ids
        self._used_allows: Set[int] = set()

    def suppressed(self, finding: Finding) -> bool:
        """A suppression covers its own line and the line directly below
        (comment-above style); marks the allow used either way."""
        for lineno in (finding.line, finding.line - 1):
            ids = self.allows.get(lineno)
            if ids and ("*" in ids or finding.rule in ids):
                self._used_allows.add(lineno)
                return True
        return False

    def unused_allow_findings(self) -> List[Finding]:
        out = []
        for lineno in sorted(set(self.allows) - self._used_allows):
            ids = ",".join(sorted(self.allows[lineno]))
            out.append(Finding(
                rule="unused-allow", path=self.path, line=lineno, col=0,
                symbol="",
                message=f"suppression allow[{ids}] matched no finding; "
                        "remove it (stale allows hide future regressions)"))
        return out

    def statement_span(self, line: int) -> Tuple[int, int]:
        """(first, last) line of the innermost statement holding ``line``;
        ``(line, line)`` outside every statement."""
        best = (line, line)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.stmt) and not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.If, ast.For, ast.While,
                           ast.With, ast.Try)):
                lo, hi = node.lineno, node.end_lineno or node.lineno
                if lo <= line <= hi and (best == (line, line)
                                         or hi - lo < best[1] - best[0]):
                    best = (lo, hi)
        return best


class Rule:
    """Base rule: subclasses set ``id`` and implement ``run``.

    ``applies(path)`` scopes the rule by posix path (relative to the scan
    root's parent, e.g. ``repro_torch/serve/engine.py``); the default is
    every scanned file.
    """

    id: str = ""
    description: str = ""

    def applies(self, path: str) -> bool:
        return True

    def run(self, mod: Module) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


def qualname_of(stack: Sequence[ast.AST]) -> str:
    """ClassName.method-style symbol for the innermost enclosing scope."""
    parts = [n.name for n in stack
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    return ".".join(parts)


def default_root() -> str:
    """The ``repro_torch`` package directory, from this file's location
    (works from any cwd, and imports nothing)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline() -> str:
    """The port's own baseline file, beside this module."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def iter_source_files(root: str) -> Iterable[Tuple[str, str]]:
    """Yield (abs_path, rel_path) for every .py under ``root``.

    ``rel_path`` is rooted at the package name (``repro_torch/...``) so
    rule scopes and baseline entries are checkout-location independent.
    """
    root = os.path.abspath(root)
    base = os.path.dirname(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__" and not d.startswith("."))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                yield full, os.path.relpath(full, base).replace(os.sep, "/")


def parse_module(path: str, rel_path: Optional[str] = None) -> Module:
    with open(path, "r", encoding="utf-8") as f:
        return Module(rel_path or path, f.read())


def run_rules(rules: Sequence[Rule], modules: Iterable[Module],
              suppressed: Optional[List[Finding]] = None) -> List[Finding]:
    """Run every applicable rule, apply suppressions, surface stale ones.
    ``suppressed``, when a list, collects the findings an allow covered."""
    findings: List[Finding] = []
    for mod in modules:
        for rule in rules:
            if not rule.applies(mod.path):
                continue
            for f in rule.run(mod):
                if not mod.suppressed(f):
                    findings.append(f)
                elif suppressed is not None:
                    suppressed.append(f)
        findings.extend(mod.unused_allow_findings())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> Set[Tuple[str, str, str, str]]:
    """Baseline keys; a missing file is an empty baseline."""
    if not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    keys = set()
    for ent in data.get("findings", ()):
        keys.add((ent["rule"], ent["path"], ent.get("symbol", ""),
                  ent["message"]))
    return keys


def diff_against_baseline(findings: Sequence[Finding],
                          baseline: Set[Tuple[str, str, str, str]],
                          ) -> Tuple[List[Finding], Set[tuple]]:
    """(new findings not in baseline, stale baseline keys no longer seen)."""
    seen = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    stale = baseline - seen
    return new, stale


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    data = {
        "_comment": "Findings grandfathered past the analysis gate. Every "
                    "entry needs a 'note' saying why it is baselined "
                    "instead of fixed; prefer fixing or an inline "
                    "'# repro: allow[rule-id]' with justification.",
        "findings": [{**f.to_json(), "note": "TODO: justify"}
                     for f in findings],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=False)
        f.write("\n")
