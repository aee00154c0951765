"""Import-graph reachability report of the port
(``python -m repro_torch.analysis --dead-code``).

Walks ``import``/``from ... import`` edges (including function-local lazy
imports, relative imports, and ``"repro_torch.x.y"`` string literals — the
worker subprocess is spawned via ``python -m repro_torch.cluster.worker``)
from the real entry points and reports modules nothing reaches.  Two
views:

  * **production roots** — ``repro_torch.launch.*``,
    ``repro_torch.examples.*`` and what ``chip_smoke.py`` imports: what a
    deployment or the card check can actually execute;
  * **+ tests** — the above plus ``tests/test_torch_*.py``: code reachable
    only from tests is exercised but ships dead weight.

Report only — dead code is a judgement call, so the CLI always exits 0.
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Dict, Iterable, List, Set

from .engine import iter_source_files

__all__ = ["report_dead_code", "reachable_modules", "module_graph"]

PACKAGE = "repro_torch"
_MODULE_STR_RE = re.compile(rf"^{PACKAGE}(\.\w+)+$")
# f"repro_torch.x.{name}"-style dynamic imports: a dotted prefix ending at a
# brace marks the whole package subtree reachable (suffix is data-driven)
_MODULE_PREFIX_RE = re.compile(rf"^{PACKAGE}(\.\w+)+\.$")
ENTRY_PACKAGES = (f"{PACKAGE}.launch", f"{PACKAGE}.examples")


def _module_name(rel_path: str) -> str:
    """'repro_torch/core/segments.py' -> 'repro_torch.core.segments';
    __init__ -> pkg."""
    parts = rel_path[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports_of(tree: ast.AST, current_pkg: str) -> Set[str]:
    """Every repro_torch-rooted module name this AST mentions."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == PACKAGE:
                    out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = current_pkg.split(".")
                # level 1 = current package, each extra level pops one
                base = base[:len(base) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod.split(".")[0] == PACKAGE:
                out.add(mod)
                for alias in node.names:
                    out.add(f"{mod}.{alias.name}")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if _MODULE_STR_RE.match(node.value):
                out.add(node.value)
        elif isinstance(node, ast.JoinedStr) and node.values:
            first = node.values[0]
            if isinstance(first, ast.Constant) and isinstance(
                    first.value, str) and _MODULE_PREFIX_RE.match(
                    first.value):
                out.add(first.value + "*")
    return out


def module_graph(root: str) -> Dict[str, Set[str]]:
    """module name -> repro_torch modules it mentions, for every file under
    root."""
    graph: Dict[str, Set[str]] = {}
    for full, rel in iter_source_files(root):
        with open(full, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=full)
        name = _module_name(rel)
        pkg = name if rel.endswith("__init__.py") else name.rsplit(".", 1)[0]
        graph[name] = _imports_of(tree, pkg)
    return graph


def _resolve(mention: str, known: Set[str]) -> Set[str]:
    """A mention marks the module itself, every ancestor package (their
    __init__ runs on import), and — for packages — their ``__main__``
    (a ``"repro_torch.x"`` launch string means ``python -m
    repro_torch.x``).  A ``pkg.*`` wildcard mention (from an f-string
    dynamic import) marks the whole subtree."""
    out = set()
    if mention.endswith(".*"):
        stem = mention[:-2]
        out |= {m for m in known
                if m == stem or m.startswith(stem + ".")}
        mention = stem
    parts = mention.split(".")
    for i in range(1, len(parts) + 1):
        prefix = ".".join(parts[:i])
        if prefix in known:
            out.add(prefix)
    if mention in known and f"{mention}.__main__" in known:
        out.add(f"{mention}.__main__")
    return out


def _external_root_imports(paths: Iterable[str]) -> Set[str]:
    out: Set[str] = set()
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        out |= _imports_of(tree, "")
    return out


def _files(directory: str, pattern: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    return [os.path.join(directory, fn) for fn in sorted(os.listdir(directory))
            if fnmatch.fnmatch(fn, pattern)]


def reachable_modules(graph: Dict[str, Set[str]],
                      roots: Iterable[str]) -> Set[str]:
    known = set(graph)
    seen: Set[str] = set()
    frontier: List[str] = []
    for mention in roots:
        frontier.extend(_resolve(mention, known))
    while frontier:
        mod = frontier.pop()
        if mod in seen:
            continue
        seen.add(mod)
        for mention in graph.get(mod, ()):
            for resolved in _resolve(mention, known):
                if resolved not in seen:
                    frontier.append(resolved)
    return seen


def report_dead_code(root: str) -> str:
    graph = module_graph(root)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(root)))
    entry_roots = {m for m in graph if m.startswith(ENTRY_PACKAGES)}
    smoke_roots = _external_root_imports(
        [os.path.join(repo_root, "chip_smoke.py")])
    test_roots = _external_root_imports(
        _files(os.path.join(repo_root, "tests"), "test_torch_*.py"))

    prod = reachable_modules(graph, entry_roots | smoke_roots)
    with_tests = reachable_modules(graph, entry_roots | smoke_roots
                                   | test_roots)

    dead_prod = sorted(set(graph) - prod)
    dead_all = sorted(set(graph) - with_tests)
    lines = [
        "dead-code report (import reachability; informational, exit 0)",
        f"  modules scanned: {len(graph)}",
        f"  production roots: {len(entry_roots)} launch/example module(s) "
        f"+ {len(smoke_roots)} chip_smoke.py import(s)",
        "",
        f"unreachable from production entry points "
        f"(launch/ + examples/ + chip_smoke.py): {len(dead_prod)}",
    ]
    for m in dead_prod:
        suffix = "  [reached by tests]" if m in with_tests else ""
        lines.append(f"  {m}{suffix}")
    lines.append("")
    lines.append(f"unreachable even counting tests: {len(dead_all)}")
    for m in dead_all:
        lines.append(f"  {m}")
    return "\n".join(lines)
