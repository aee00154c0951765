"""Closed loop: one caller, in this process's thread, sending its next
request once the previous one has returned.  A request is one batch of the
engine: ``serve.batch_size`` queries.

Traffic keys: ``serve`` (the engine's ``ServeConfig``), ``warm_requests``
(requests served before the window, as set-up).
"""
from __future__ import annotations

import time
from typing import Callable, List

import numpy as np

__all__ = ["Request", "Requests", "serve_until"]


class Request:
    """One request: its index in the stream, host times, and its answer."""

    __slots__ = ("index", "t0", "t1", "dists", "ids", "error")

    def __init__(self, index: int):
        self.index = index
        self.t0 = self.t1 = 0.0
        self.dists = self.ids = None
        self.error = None

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


class Requests:
    """The request stream of a query set: request r holds queries r*B .. r*B
    + B - 1 of the set, wrapping around; each one is a view of a tiled host
    copy, ready before the previous request returns."""

    def __init__(self, queries: np.ndarray, traffic: dict):
        self.size = int(traffic["serve"]["batch_size"])
        nq = queries.shape[0]
        copies = -(-(nq + self.size) // nq)
        self.nq = nq
        self.tiled = np.ascontiguousarray(np.concatenate([queries] * copies))

    def __call__(self, r: int) -> np.ndarray:
        lo = (r * self.size) % self.nq
        return self.tiled[lo:lo + self.size]

    def rows(self, r: int) -> np.ndarray:
        """Positions in the query set of request r's queries."""
        return (r * self.size + np.arange(self.size)) % self.nq


def serve_until(serve: Callable, requests: Requests, first: int, deadline: float,
                min_requests: int = 1) -> List[Request]:
    """Send requests ``first``, ``first + 1``, ... until the host clock passes
    ``deadline`` (and at least ``min_requests`` were sent); each is timed
    from the call into the engine to its answer on the host."""
    done: List[Request] = []
    r = first
    while not done or len(done) < min_requests or time.perf_counter() < deadline:
        req = Request(r)
        batch = requests(r)
        req.t0 = time.perf_counter()
        try:
            req.dists, req.ids = serve(batch)
        except Exception as err:        # a failed request is counted, not fatal
            req.error = f"{type(err).__name__}: {err}"
        req.t1 = time.perf_counter()
        done.append(req)
        r += 1
    return done
