"""Intra-function taint dataflow shared by rules R1 and R2, the port's copy
of the JAX package's ``analysis.taint``.

One deliberately simple model, tuned for this codebase's idioms rather
than general soundness:

  * analysis is per-function, statements in source order (loops are not
    iterated to a fixpoint; a name tainted on line N is tainted for every
    later line — linear approximation);
  * each local name maps to a set of string **tags**.  A rule supplies a
    :class:`TaintConfig` naming which calls/attributes *introduce* a tag,
    which calls *clear* all tags (host sinks return host scalars), and
    how unknown expressions combine (union of sub-expression tags);
  * function parameters start untainted: cross-function flow is the
    *call site's* problem, which keeps every rule intra-module and every
    finding locally explainable;
  * tuple literals, subscripts, unary/binary ops, and unpacking
    propagate tags; **list/set/dict literals do not** — truthiness and
    iteration of a host container of device values is host-side work
    (``if not results:`` over a list of device tuples is fine; syncing
    an element of it is caught when the element itself is used).

Call targets are matched on their *terminal* name (``x.max`` -> ``max``,
``pipe.pick_rung`` -> ``pick_rung``, ``self.index.query_compact`` ->
``query_compact``) plus the dotted prefix for module roots (``torch.*``).
That is exactly as precise as single-module AST analysis can be, and it
is enough: the hot-path modules pin their vocabulary.  A rule may also
give a ``call_hook``, asked first for every call: torch decides by a
call's arguments whether a tensor lands on the host or the card
(``torch.as_tensor(x)`` against ``torch.as_tensor(x, device=...)``,
``t.to(torch.int32)`` against ``t.to(device)``).
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["TaintConfig", "FunctionTaint", "call_name", "terminal_name",
           "iter_functions"]


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target, best effort ('' when unresolvable)."""
    return _dotted(node.func)


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def terminal_name(dotted: str) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def iter_functions(tree: ast.AST,
                   ) -> Iterable[Tuple[List[ast.AST], ast.FunctionDef]]:
    """(enclosing stack, function) for every def, outermost first."""
    stack: List[ast.AST] = []

    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield list(stack), child
                stack.append(child)
                yield from walk(child)
                stack.pop()
            elif isinstance(child, ast.ClassDef):
                stack.append(child)
                yield from walk(child)
                stack.pop()
            else:
                yield from walk(child)

    yield from walk(tree)


@dataclasses.dataclass
class TaintConfig:
    """What introduces, clears, and blocks taint for one rule."""

    # asked first for every call: the call's tags, or None to go on with
    # the tables below
    call_hook: Optional[Callable[[ast.Call, "FunctionTaint"],
                                 Optional[Set[str]]]] = None
    # call terminal names whose RESULT carries this tag
    source_calls: Dict[str, str] = dataclasses.field(default_factory=dict)
    # terminal names that return host values even under a source prefix
    # (torch.iinfo, torch.cuda.device_count, t.numel(), ...): checked FIRST
    # after the hook
    neutral_calls: Set[str] = dataclasses.field(default_factory=set)
    # dotted call prefixes ('torch') whose result carries the tag
    source_prefixes: Dict[str, str] = dataclasses.field(default_factory=dict)
    # terminal attribute names whose access introduces the tag regardless
    # of base (e.g. IndexState device fields)
    source_attrs: Dict[str, str] = dataclasses.field(default_factory=dict)
    # call terminal names whose result is always untainted (host sinks:
    # the CALL may be a finding, but its result is a host scalar)
    clearing_calls: Set[str] = dataclasses.field(default_factory=set)
    # attribute accesses that return host metadata, not the value
    clearing_attrs: Set[str] = dataclasses.field(
        default_factory=lambda: {"shape", "ndim", "dtype", "itemsize",
                                 "nbytes"})


class FunctionTaint:
    """Statement-order taint environment for one function body."""

    def __init__(self, fn: ast.FunctionDef, config: TaintConfig):
        self.config = config
        self.env: Dict[str, Set[str]] = {}
        self._run_body(fn.body)

    # -- expression tagging -------------------------------------------------

    def tags(self, node: Optional[ast.AST]) -> Set[str]:
        if node is None:
            return set()
        c = self.config
        if isinstance(node, ast.Name):
            return set(self.env.get(node.id, ()))
        if isinstance(node, ast.Constant):
            return set()
        if isinstance(node, ast.Call):
            if c.call_hook is not None:
                hooked = c.call_hook(node, self)
                if hooked is not None:
                    return hooked
            dotted = call_name(node)
            term = terminal_name(dotted)
            if term in c.neutral_calls:
                return set()
            for prefix, tag in c.source_prefixes.items():
                if dotted.startswith(prefix + "."):
                    return {tag}
            if term in c.source_calls:
                return {c.source_calls[term]}
            if term in c.clearing_calls:
                return set()
            out: Set[str] = set()
            # a method call on a tainted object stays tainted (x.max())
            if isinstance(node.func, ast.Attribute):
                out |= self.tags(node.func.value)
            for a in node.args:
                out |= self.tags(a)
            for kw in node.keywords:
                out |= self.tags(kw.value)
            return out
        if isinstance(node, ast.Attribute):
            if node.attr in c.clearing_attrs:
                return set()
            if node.attr in c.source_attrs:
                return {c.source_attrs[node.attr]}
            return self.tags(node.value)
        if isinstance(node, ast.Subscript):
            return self.tags(node.value) | self.tags(node.slice)
        if isinstance(node, (ast.Tuple,)):
            out = set()
            for elt in node.elts:
                out |= self.tags(elt)
            return out
        if isinstance(node, (ast.List, ast.Set, ast.Dict, ast.ListComp,
                             ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            return set()        # host containers: see module docstring
        if isinstance(node, ast.BinOp):
            return self.tags(node.left) | self.tags(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tags(node.operand)
        if isinstance(node, ast.BoolOp):
            out = set()
            for v in node.values:
                out |= self.tags(v)
            return out
        if isinstance(node, ast.Compare):
            out = self.tags(node.left)
            for comp in node.comparators:
                out |= self.tags(comp)
            return out
        if isinstance(node, ast.IfExp):
            return self.tags(node.body) | self.tags(node.orelse)
        if isinstance(node, ast.Starred):
            return self.tags(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.tags(node.value)
        if isinstance(node, ast.JoinedStr):
            return set()
        if isinstance(node, ast.Slice):
            return (self.tags(node.lower) | self.tags(node.upper)
                    | self.tags(node.step))
        if isinstance(node, ast.Lambda):
            return set()
        return set()

    # -- statement walk -----------------------------------------------------

    def _bind(self, target: ast.AST, tags: Set[str]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = set(tags)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tags)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tags)
        # attribute/subscript stores don't bind local names

    def _run_body(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._run_stmt(stmt)

    def _run_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            t = self.tags(stmt.value)
            for target in stmt.targets:
                self._bind(target, t)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None and stmt.target is not None:
                self._bind(stmt.target, self.tags(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            if isinstance(stmt.target, ast.Name):
                t = self.tags(stmt.target) | self.tags(stmt.value)
                self.env[stmt.target.id] = t
        elif isinstance(stmt, ast.For):
            self._bind(stmt.target, self.tags(stmt.iter))
            self._run_body(stmt.body)
            self._run_body(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self._run_body(stmt.body)
            self._run_body(stmt.orelse)
        elif isinstance(stmt, ast.If):
            self._run_body(stmt.body)
            self._run_body(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    self._bind(item.optional_vars,
                               self.tags(item.context_expr))
            self._run_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._run_body(stmt.body)
            for h in stmt.handlers:
                self._run_body(h.body)
            self._run_body(stmt.orelse)
            self._run_body(stmt.finalbody)
        # nested defs/classes are analyzed as their own functions; plain
        # expression statements don't bind names

    def tainted_in_branch_test(self, test: ast.AST) -> Set[str]:
        """Tags participating in a *value* comparison within a branch test.

        Identity/membership checks (``is None``, ``x in warm_set``) are
        host-side bookkeeping even on device handles — only numeric /
        equality comparisons and bare truthiness force a device sync.
        """
        if isinstance(test, ast.BoolOp):
            out: Set[str] = set()
            for v in test.values:
                out |= self.tainted_in_branch_test(v)
            return out
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.tainted_in_branch_test(test.operand)
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in test.ops):
                return set()
            return self.tags(test)
        return self.tags(test)
