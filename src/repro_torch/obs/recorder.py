"""Flight recorder (DESIGN.md §12): what just happened, and why was it slow.

A fixed-size ring buffer of per-batch flight records — always on, bounded
by construction (two ``deque(maxlen=…)``, nothing grows with uptime) —
plus **slow-query exemplar capture**: any batch over ``slow_ms`` is
copied into a second ring with everything needed to do the postmortem
without reproducing the query: the rung/cbucket decisions the compacted
probe made, the shard/batch shape, and (under ``REPRO_TRACE=1``) the full
span tree of the batch as captured by ``trace.capture_begin/end``.

The engine owns one recorder per process (batch granularity — rung and
cbucket decisions live there) and the router owns one at dispatch
granularity (fan-out/hedge timing).  ``telemetry()`` ships the engine
recorder's summary + exemplars over the ordinary JSON meta, so a slow
worker's evidence is reachable from the router without new RPCs.
"""
from __future__ import annotations

import collections
import time
from typing import Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring of (wall_s, ms, entry) batch records + slow exemplars."""

    def __init__(self, capacity: int = 256, slow_ms: float = 50.0,
                 exemplar_capacity: int = 16):
        self.capacity = int(capacity)
        self.slow_ms = float(slow_ms)
        self.exemplar_capacity = int(exemplar_capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._exemplars = collections.deque(maxlen=self.exemplar_capacity)
        self.recorded = 0
        self.slow_batches = 0

    def record(self, ms: float, entry: dict,
               spans=None) -> Optional[dict]:
        """Append one flight record; returns the exemplar if it was slow.

        ``entry`` is a small JSON-able dict (batch shape, rung decisions);
        ``spans`` is the batch's captured span tree (empty unless tracing).
        """
        self.recorded += 1
        self._ring.append((time.time(), float(ms), entry))
        if ms <= self.slow_ms:
            return None
        self.slow_batches += 1
        exemplar = {"wall_s": time.time(), "ms": float(ms), **entry,
                    "spans": list(spans or ())}
        self._exemplars.append(exemplar)
        return exemplar

    def entries(self) -> list:
        return list(self._ring)

    def exemplars(self) -> list:
        return list(self._exemplars)

    def summary(self) -> dict:
        return {"capacity": self.capacity, "recorded": self.recorded,
                "slow_ms": self.slow_ms, "slow_batches": self.slow_batches,
                "exemplar_count": len(self._exemplars)}
