"""Typed metrics registry (DESIGN.md §12): one mergeable-snapshot API.

Replaces the ``engine.stats`` / ``replica.telemetry()`` / ``router.summary()``
dict sprawl with three typed instruments behind a single registry:

  * **counters** — monotonic scalars (int or float accumulators).  The
    registry itself is a dict-style facade over them, so the historical
    ``stats["batches"] += 1`` call sites keep working verbatim;
  * **families** — labeled counters (``collections.Counter``), e.g. the
    per-candidate-bucket dispatch distribution;
  * **histograms** — log₂-bucketed latency histograms with
    ``2**HIST_SUBBUCKET_BITS`` log-linear sub-buckets per octave.  O(1)
    memory (the bucket table is bounded by ``_NBUCKETS`` regardless of how
    many samples arrive), allocation-free recording on the hot path (two
    int adds into a preallocated-once dict slot), and **exact quantile
    bounds**: ``quantile_bounds(q)`` returns ``[lo, hi)`` such that the
    true q-quantile of everything ever recorded provably lies inside —
    bucket width is ≤12.5% of its lower edge, so p50/p99/p99.9 are tight
    without keeping samples.

Snapshots are plain JSON-able dicts, so they cross the RPC transport's
JSON meta unchanged, and ``merge_snapshots`` is **commutative and
associative** with the empty snapshot as identity (counters and histogram
buckets add; gauges add — they are occupancy-style in this codebase, so
cluster-wide sums are the meaningful roll-up).  The router folds one
snapshot per replica into a cluster view with it; tests pin the algebra.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, Optional, Tuple

__all__ = ["HIST_SUBBUCKET_BITS", "Histogram", "MetricsRegistry",
           "merge_snapshots", "summarize_snapshot"]

HIST_SUBBUCKET_BITS = 3             # 8 log-linear sub-buckets per octave
_SUB = 1 << HIST_SUBBUCKET_BITS
_NBUCKETS = 64 * _SUB               # covers any int64 microsecond value


def _bucket_of(us: int) -> int:
    """Log-linear bucket index of a non-negative microsecond value."""
    if us < _SUB:
        return us                   # exact resolution for tiny values
    msb = us.bit_length() - 1
    sub = (us >> (msb - HIST_SUBBUCKET_BITS)) - _SUB
    b = ((msb - HIST_SUBBUCKET_BITS + 1) << HIST_SUBBUCKET_BITS) + sub
    return b if b < _NBUCKETS else _NBUCKETS - 1


def _bucket_bounds_us(b: int) -> Tuple[int, int]:
    """Half-open ``[lo, hi)`` microsecond range bucket ``b`` covers."""
    if b < _SUB:
        return b, b + 1
    octave, sub = b >> HIST_SUBBUCKET_BITS, b & (_SUB - 1)
    lo = (_SUB + sub) << (octave - 1)
    return lo, lo + (1 << (octave - 1))


class Histogram:
    """Log₂-bucketed latency histogram with exact quantile bounds."""

    __slots__ = ("_buckets", "count", "sum_ms", "max_us")

    def __init__(self):
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum_ms = 0.0
        self.max_us = 0

    def record_ms(self, ms: float) -> None:
        """Hot path: two int adds + one float add, no allocation after a
        bucket's first hit (≤ ``_NBUCKETS`` firsts ever)."""
        us = int(ms * 1000.0)
        if us < 0:
            us = 0
        b = _bucket_of(us)
        self._buckets[b] = self._buckets.get(b, 0) + 1
        self.count += 1
        self.sum_ms += ms
        if us > self.max_us:
            self.max_us = us

    @property
    def mean_ms(self) -> float:
        return self.sum_ms / self.count if self.count else 0.0

    def quantile_bounds(self, q: float) -> Tuple[float, float]:
        """Exact ``[lo, hi)`` ms bounds containing the q-quantile."""
        return _quantile_bounds(self._buckets, self.count, q, self.max_us)

    def quantile_ms(self, q: float) -> float:
        """Conservative (upper-bound) q-quantile in ms."""
        return self.quantile_bounds(q)[1]

    def snapshot(self) -> dict:
        return {"count": self.count, "sum_ms": self.sum_ms,
                "max_us": self.max_us, "buckets": dict(self._buckets)}


def _intkeys(d: dict) -> Dict[int, int]:
    """JSON meta stringifies int keys on the wire; undo that on merge."""
    return {int(k): int(v) for k, v in d.items()}


def _quantile_bounds(buckets: Dict, count: int, q: float,
                     max_us: int) -> Tuple[float, float]:
    if count <= 0:
        return 0.0, 0.0
    rank = min(count, max(1, math.ceil(q * count)))
    cum = 0
    for b in sorted(int(k) for k in buckets):
        cum += int(buckets[b] if b in buckets else buckets[str(b)])
        if cum >= rank:
            lo, hi = _bucket_bounds_us(b)
            # the recorded max tightens the top bucket's open edge
            hi = min(hi, max_us + 1) if max_us else hi
            return lo / 1000.0, max(lo, hi) / 1000.0
    lo, hi = _bucket_bounds_us(max(int(k) for k in buckets))
    return lo / 1000.0, hi / 1000.0


class MetricsRegistry:
    """Process-local metrics home; dict-style facade over its counters.

    ``reg["x"] += 1`` and ``reg.get("x", 0)`` hit the counter table (an
    unknown counter reads as 0), ``reg["fam"]`` returns a registered
    family Counter, ``reg.histogram(name)`` get-or-creates a histogram.
    The facade is what lets the engine/router keep their historical
    ``self.stats`` mutation sites unchanged while everything lands in one
    snapshottable registry.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._families: Dict[str, collections.Counter] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- dict-style counter facade (legacy ``stats`` call sites) -----------

    def __getitem__(self, key: str):
        fam = self._families.get(key)
        if fam is not None:
            return fam
        return self._counters.get(key, 0)

    def __setitem__(self, key: str, value) -> None:
        self._counters[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._counters or key in self._families

    def get(self, key: str, default=None):
        if key in self._families:
            return self._families[key]
        return self._counters.get(key, default)

    # -- typed instruments --------------------------------------------------

    def family(self, name: str) -> collections.Counter:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = collections.Counter()
        return fam

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def gauge_set(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    # -- snapshots ----------------------------------------------------------

    def as_dict(self) -> dict:
        """Scalar counters + families as one flat dict (the legacy
        ``summary()`` expansion shape)."""
        out: dict = dict(self._counters)
        for name, fam in self._families.items():
            out[name] = dict(sorted(fam.items()))
        return out

    def snapshot(self) -> dict:
        """JSON-able, mergeable view of everything in the registry."""
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "families": {n: dict(f) for n, f in self._families.items()},
            "histograms": {n: h.snapshot() for n, h in self._hists.items()},
        }


def merge_snapshots(a: Optional[dict], b: Optional[dict]) -> dict:
    """Commutative + associative fold of two registry snapshots.

    Counters, gauges, family labels, and histogram buckets all add;
    histogram ``max_us`` takes the max.  ``None``/empty is the identity,
    so a reduce over any replica ordering lands on the same cluster view.
    """
    a, b = a or {}, b or {}
    out: dict = {"counters": {}, "gauges": {}, "families": {},
                 "histograms": {}}
    for section in ("counters", "gauges"):
        merged = dict(a.get(section, {}))
        for k, v in b.get(section, {}).items():
            merged[k] = merged.get(k, 0) + v
        out[section] = merged
    fams = {n: collections.Counter(_intkeys(f))
            for n, f in a.get("families", {}).items()}
    for n, f in b.get("families", {}).items():
        fams.setdefault(n, collections.Counter()).update(_intkeys(f))
    out["families"] = {n: dict(f) for n, f in fams.items()}
    hists = {n: {"count": int(h.get("count", 0)),
                 "sum_ms": float(h.get("sum_ms", 0.0)),
                 "max_us": int(h.get("max_us", 0)),
                 "buckets": _intkeys(h.get("buckets", {}))}
             for n, h in a.get("histograms", {}).items()}
    for n, h in b.get("histograms", {}).items():
        cur = hists.setdefault(n, {"count": 0, "sum_ms": 0.0, "max_us": 0,
                                   "buckets": {}})
        cur["count"] += int(h.get("count", 0))
        cur["sum_ms"] += float(h.get("sum_ms", 0.0))
        cur["max_us"] = max(cur["max_us"], int(h.get("max_us", 0)))
        for k, v in _intkeys(h.get("buckets", {})).items():
            cur["buckets"][k] = cur["buckets"].get(k, 0) + v
    out["histograms"] = hists
    return out


def summarize_snapshot(snap: Optional[dict]) -> Optional[dict]:
    """Human-facing roll-up of a (possibly merged) snapshot: counters as
    they are, each histogram reduced to count/mean/p50/p99/p99.9 upper
    bounds (the exact-bounds contract, DESIGN.md §12)."""
    if not snap:
        return None
    hists = {}
    for name, h in snap.get("histograms", {}).items():
        count = int(h.get("count", 0))
        buckets = h.get("buckets", {})
        max_us = int(h.get("max_us", 0))
        hists[name] = {
            "count": count,
            "mean_ms": (float(h.get("sum_ms", 0.0)) / count) if count else 0.0,
            "p50_ms": _quantile_bounds(buckets, count, 0.50, max_us)[1],
            "p99_ms": _quantile_bounds(buckets, count, 0.99, max_us)[1],
            "p999_ms": _quantile_bounds(buckets, count, 0.999, max_us)[1],
        }
    return {"counters": dict(snap.get("counters", {})),
            "gauges": dict(snap.get("gauges", {})),
            "families": {n: _intkeys(f)
                         for n, f in snap.get("families", {}).items()},
            "histograms": hists}
