"""Opt-in runtime race sanitizer for engine/replica state (DESIGN.md §11),
the port's copy of the JAX package's ``analysis.racecheck``.

It checks the quiesce-before-mutation contract *dynamically*, catching
what a static rule cannot see — monkeypatched methods, new call paths, a
future a router forgot to track:

  * every instrumented object carries a :class:`StateToken` with a lock,
    an **epoch** (bumped per mutation), and per-thread query/mutation
    depth counters;
  * a mutation entering while another thread is inside a query (or
    another mutation) raises :class:`RaceViolation`; so does a query
    discovering on exit that a *different* thread advanced the epoch
    while it ran — the straggler-reads-torn-state half of the race;
  * same-thread nesting is allowed (``drain() -> compact()``,
    ``catch_up_from() -> apply_records()`` are legal reentrancy).

``RaceViolation`` subclasses ``BaseException`` deliberately: the router
wraps replica calls in broad ``except Exception`` fault-tolerance
handlers (that is the *point* of the cluster layer), and a sanitizer
report must not be absorbed as a routine replica failure.

Everything is inert unless ``REPRO_SANITIZE=1``: ``maybe_instrument`` is
a no-op, so production pays nothing.  Instrumentation is applied at the
END of each constructor — ctor-internal calls (``recover()`` during
boot) are single-threaded by construction and stay unwrapped.
"""
from __future__ import annotations

import functools
import os
import threading
from typing import Dict, Iterable

__all__ = ["RaceViolation", "StateToken", "enabled", "maybe_instrument"]


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE") == "1"


class RaceViolation(BaseException):
    """Query-vs-mutation overlap on an instrumented engine/replica.

    BaseException so the router's ``except Exception`` fault-tolerance
    handlers cannot swallow it as a replica failure.
    """


class StateToken:
    """Owner/epoch token guarding one engine or replica instance."""

    def __init__(self, name: str):
        self.name = name
        self.epoch = 0
        self.last_mutator: int = -1
        self._lock = threading.Lock()
        self._queries: Dict[int, int] = {}    # thread ident -> depth
        self._mutations: Dict[int, int] = {}

    def _others_in(self, table: Dict[int, int], me: int) -> bool:
        return any(depth > 0 for tid, depth in table.items() if tid != me)

    # -- queries ------------------------------------------------------------

    def enter_query(self) -> int:
        me = threading.get_ident()
        with self._lock:
            if self._others_in(self._mutations, me):
                raise RaceViolation(
                    f"[{self.name}] query started while a mutation is in "
                    f"flight on thread {self.last_mutator} — straggler was "
                    "not quiesced (DESIGN.md §7)")
            self._queries[me] = self._queries.get(me, 0) + 1
            return self.epoch

    def exit_query(self, epoch_at_entry: int) -> None:
        me = threading.get_ident()
        with self._lock:
            self._queries[me] = max(0, self._queries.get(me, 0) - 1)
            if self.epoch != epoch_at_entry and self.last_mutator != me:
                raise RaceViolation(
                    f"[{self.name}] state mutated by thread "
                    f"{self.last_mutator} while this query ran (epoch "
                    f"{epoch_at_entry} -> {self.epoch}) — the query may "
                    "have read torn state (DESIGN.md §7)")

    # -- mutations ----------------------------------------------------------

    def enter_mutation(self) -> None:
        me = threading.get_ident()
        with self._lock:
            if self._others_in(self._queries, me):
                raise RaceViolation(
                    f"[{self.name}] mutation started while another "
                    "thread's query is in flight — caller skipped the "
                    "straggler quiesce (DESIGN.md §7)")
            if self._others_in(self._mutations, me):
                raise RaceViolation(
                    f"[{self.name}] concurrent mutations from two threads "
                    "(DESIGN.md §7)")
            self._mutations[me] = self._mutations.get(me, 0) + 1
            self.epoch += 1
            self.last_mutator = me

    def exit_mutation(self) -> None:
        me = threading.get_ident()
        with self._lock:
            self._mutations[me] = max(0, self._mutations.get(me, 0) - 1)


def _wrap(token: StateToken, fn, kind: str):
    if kind == "query":
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            epoch = token.enter_query()
            try:
                return fn(*args, **kwargs)
            finally:
                token.exit_query(epoch)
    else:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            token.enter_mutation()
            try:
                return fn(*args, **kwargs)
            finally:
                token.exit_mutation()
    wrapper.__repro_sanitized__ = kind
    return wrapper


def maybe_instrument(obj, name: str, queries: Iterable[str] = (),
                     mutations: Iterable[str] = ()) -> None:
    """Wrap ``obj``'s listed bound methods with race tokens (no-op unless
    ``REPRO_SANITIZE=1``).  Call at the END of the constructor so boot-time
    internal calls stay unwrapped.  Missing methods are skipped: subclasses
    and remote proxies share instrumentation lists.
    """
    if not enabled():
        return
    token = getattr(obj, "__repro_race_token__", None)
    if token is None:
        token = StateToken(name)
        obj.__repro_race_token__ = token
    for kind, methods in (("query", queries), ("mutation", mutations)):
        for meth in methods:
            fn = getattr(obj, meth, None)
            if fn is None or getattr(fn, "__repro_sanitized__", None):
                continue
            setattr(obj, meth, _wrap(token, fn, kind))
