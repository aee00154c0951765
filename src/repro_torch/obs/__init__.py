"""repro_torch.obs — observability for the port's serving stack, the
port's own copy of the JAX package's ``obs`` (DESIGN.md §12).

Three pieces, one package, stdlib-only (safe to import anywhere, torch or
not), with the same env switches and the same span file format, so a trace
the port writes renders with either package:

  * :mod:`repro_torch.obs.metrics` — typed metrics registry (counters,
    gauges, families, log₂-bucketed histograms) with mergeable JSON
    snapshots;
  * :mod:`repro_torch.obs.trace` — ``REPRO_TRACE=1`` opt-in spans, exported
    as Chrome trace-event JSON via ``python -m repro_torch.obs render``;
  * :mod:`repro_torch.obs.recorder` — fixed-size flight recorder with
    slow-query exemplar capture.
"""
from . import metrics, recorder, render, trace
from .metrics import (HIST_SUBBUCKET_BITS, Histogram, MetricsRegistry,
                      merge_snapshots, summarize_snapshot)
from .recorder import FlightRecorder

__all__ = ["metrics", "recorder", "render", "trace",
           "HIST_SUBBUCKET_BITS", "Histogram", "MetricsRegistry",
           "merge_snapshots", "summarize_snapshot", "FlightRecorder"]
