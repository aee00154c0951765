"""Whether the timed path answered correctly.

Once the window has closed, requests are drawn from the seed among those the
window sent, at least ``SAMPLE_QUERIES`` queries' worth, and every query of
each drawn request is answered again by the plain reference, which builds
its own tables from the same points and hash parameters.  One number is
compared against its limit (set in PERF.md from sound runs and the
control):

* ``mismatched_queries``: drawn queries whose k (distance, id) pairs differ
  from the reference's anywhere, or that got no answer (their request
  raised).  The comparison is exact, so the limit is 0.

On several cards the answers judged are rank 0's, and the reference is the
per-shard reference merged (``reference.lsh.merge``); a drawn query that
another rank answered otherwise than rank 0 counts as mismatched too.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["SAMPLE_QUERIES", "LIMITS", "draw", "mismatched", "judge", "correct", "lines"]

SAMPLE_QUERIES = 2048
LIMITS = {"mismatched_queries": 0}


def draw(requests: List, request_queries: int, seed: int) -> List:
    """The requests whose answers are compared, drawn from the seed."""
    if not requests:
        return []
    rng = np.random.default_rng([abs(int(seed)), int(seed < 0), 7])
    want = min(len(requests), math.ceil(SAMPLE_QUERIES / request_queries))
    pick = np.sort(rng.choice(len(requests), size=want, replace=False))
    return [requests[i] for i in pick]


def _differs(got_d, got_i, want_d, want_i) -> np.ndarray:
    """Per query: whether its k (distance, id) pairs differ anywhere."""
    got_d, got_i = np.asarray(got_d), np.asarray(got_i)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    if got_d.shape != want_d.shape or got_i.shape != want_i.shape:
        return np.ones(want_d.shape[0], bool)
    return ((got_d != want_d) | (got_i != want_i)).any(axis=-1)


def mismatched(got_d, got_i, want_d, want_i) -> int:
    """Queries whose k (distance, id) pairs differ anywhere."""
    return int(_differs(got_d, got_i, want_d, want_i).sum())


def judge(drawn: List, answer, peers: Sequence[Sequence] = ()) -> Dict[str, Dict[str, int]]:
    """``answer(request) -> (dists, ids)`` the reference's (Q, k) numpy
    answers for a request's queries; ``peers``, one list a further rank, its
    (dists, ids) answer to each drawn request.  Returns each number with its
    limit."""
    wrong = 0
    for n, req in enumerate(drawn):
        want_d, want_i = answer(req)
        if req.error is not None or req.dists is None:
            wrong += want_d.shape[0]
            continue
        bad = _differs(req.dists, req.ids, want_d, want_i)
        for peer in peers:
            bad |= _differs(peer[n][0], peer[n][1], req.dists, req.ids)
        wrong += int(bad.sum())
    return {"mismatched_queries": {"value": int(wrong), "limit": LIMITS["mismatched_queries"]}}


def correct(checks: Dict[str, Dict[str, int]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def lines(checks: Dict[str, Dict[str, int]], compared: int) -> List[str]:
    return ([f"compared {compared} queries with the reference"]
            + [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()])
