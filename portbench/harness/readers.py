"""What the metric readers share: each ``portbench/metrics/<name>.py`` is a
line or two over these.  A reader returns ``None`` when the run holds
nothing it can read, and the metric is then left out of the result."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from portbench.harness import program, workcount

__all__ = ["queries_per_s", "latency_ms", "peak_gib", "setup_s", "idle_share",
           "roofline", "rerank_work", "span_ms", "kernels_per_batch",
           "RERANK_KERNELS", "GATHER_KERNELS"]

# the port's device kernels of the rerank launch and of the gather launch
RERANK_KERNELS = program.kernels_of("fused_rerank")
GATHER_KERNELS = program.kernels_of("fused_probe_gather")


def queries_per_s(run) -> Optional[float]:
    """Queries answered in the window over the window's host time."""
    if run.window_s <= 0 or not run.queries_done:
        return None
    return run.queries_done / run.window_s


def latency_ms(run, q: float) -> Optional[float]:
    """The q-th percentile of the window's request times."""
    lat = run.latencies_ms
    return float(np.percentile(lat, q)) if lat else None


def peak_gib(run) -> Optional[float]:
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None


def setup_s(run) -> float:
    return run.setup_s


def idle_share(run) -> Optional[float]:
    """Percent of the kept profiled window with no operation on the device."""
    w = run.profile
    if w is None or w.window_s <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def roofline(run, kernels: Sequence[str],
             work: Callable[[Dict], Tuple[float, float]]) -> Optional[float]:
    """Percent: the least time of the kept window's counted work over the
    profiler's device time of ``kernels`` in that window."""
    w = run.profile
    if w is None or not run.kept_batches:
        return None
    seconds = w.kernel_s(kernels)
    if seconds <= 0:
        return None
    least = workcount.bound_s((work(c) for c in run.counts()), workcount.peaks())
    return 100.0 * least / seconds


def rerank_work(run) -> Callable[[Dict], Tuple[float, float]]:
    """The cell's rerank work function: its row width, value bytes and k."""
    ix, dim = run.cell.config["index"], int(run.cell.config["data"]["dim"])
    value_bytes = 2 if ix.get("dataset_dtype", "int32") == "int16" else 4
    return lambda c: workcount.rerank_work(c, dim, value_bytes, int(ix["k"]))


def span_ms(run, name: str) -> Optional[float]:
    """Mean duration of the program's spans called ``name``."""
    durs = [s["dur"] for s in run.spans if s.get("name") == name]
    return float(np.mean(durs)) / 1e3 if durs else None


def kernels_per_batch(run) -> Optional[float]:
    """Device kernel records of the kept window per batch it served."""
    w = run.profile
    if w is None or not w.batches:
        return None
    count = w.kernel_count()
    return count / w.batches if count else None
