"""Least device time of a kernel's work, counted from the cell's inputs.

The counts come from the reference (``reference.lsh.work``): what a batch
asks of the probe's gather and of the rerank under the configuration's
semantics, never the program's rung, slab or cap.  Each input byte is
counted once and each output byte once, whatever a kernel reads again; the
least time is the larger of bytes over the card's memory bandwidth and
integer operations over its INT32 issue rate (``peaks.json``, with the
source of each).  This is the chip smoke's bound arithmetic, fed with
counted work, at the INT32 rate where the smoke took the FP32 one.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["peaks", "least_s", "rerank_work", "gather_work", "bound_s"]

ID_BYTES = 4         # int32 candidate ids, extents and counts
QUERY_VALUE_BYTES = 4


def peaks() -> Dict[str, float]:
    return json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def least_s(nbytes: float, ops: float, pk: Dict[str, float]) -> float:
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["int32_ops_per_s"])


def rerank_work(c: Dict[str, int], dim: int, value_bytes: int, k: int) -> Tuple[float, float]:
    """(bytes, ops) of one batch's rerank: the valid candidate ids, each
    distinct row of the batch once, the queries, and k (distance, id)
    answers a query; a subtract, an absolute value and an add a coordinate
    of each distinct (query, row) pair."""
    nbytes = (c["slots"] * ID_BYTES + c["rows"] * dim * value_bytes
              + c["queries"] * dim * QUERY_VALUE_BYTES + c["queries"] * k * 2 * ID_BYTES)
    return float(nbytes), float(3 * dim * c["pairs"])


def gather_work(c: Dict[str, int]) -> Tuple[float, float]:
    """(bytes, ops) of one batch's candidate gather: each probe's extent
    (start, occupancy), the ids of each distinct probed bucket's first
    min(occupancy, C) rows once, the valid candidate ids written, and a
    count a query."""
    nbytes = (c["probes"] * 2 * ID_BYTES + c["bucket_ids"] * ID_BYTES
              + c["slots"] * ID_BYTES + c["queries"] * ID_BYTES)
    return float(nbytes), 0.0


def bound_s(works: Iterable[Tuple[float, float]], pk: Dict[str, float]) -> float:
    """Least time of a window's launches: each launch's bound, summed."""
    return sum(least_s(b, o, pk) for b, o in works)
