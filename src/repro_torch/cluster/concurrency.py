"""Concurrency contract markers of the cluster layer, torch counterpart of
``repro.cluster.concurrency`` (DESIGN.md §7, §11).

``@under_quiesce`` is a zero-cost marker: it declares that every call to
the decorated function happens with the hedged-straggler quiesce already
taken (the caller ran ``ClusterRouter._quiesce`` first, or is itself so
marked).  The ``r4-mutation-discipline`` rule treats marked functions as
sanctioned internally and as *mutators* externally — the obligation
travels to each call site instead of silently disappearing.
"""
from __future__ import annotations

from typing import Callable, TypeVar

__all__ = ["under_quiesce"]

F = TypeVar("F", bound=Callable)


def under_quiesce(fn: F) -> F:
    """Mark ``fn`` as only callable once stragglers are quiesced."""
    fn.__requires_quiesce__ = True
    return fn
